"""The data-parallel pipeline, sharded evaluation and sharded replicas of the
port on two gloo CPU ranks: the unimodal 3-stage pipeline with
``dp_devices=2`` at one batch per stage (rank 0 alone writes, every rank gets
the results, a second run resumes on every rank), ``mesh=`` embeddings and KNN against the unsharded calls, and
``shard_replicas`` fits against the unsharded ensemble (JAX's
test_sharded_ensemble_matches holds its sharded replicas to rtol 1.5e-2).
Rank workers are tests/_torch_dp_workers.py."""

import pathlib

import numpy as np
import pytest
import torch

import _torch_dp_workers as W
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train import ensemble as tens
from test_torch_dp import _weights

torch.set_num_threads(1)

DATA_ROOT = str(pathlib.Path(__file__).resolve().parent.parent / "datasets")
DS = "cellexplorer-celltype"


def _eval_inputs():
    r = np.random.default_rng(4)
    data = r.normal(size=(37, 50)).astype(np.float32)  # 37 rows: padded to 38 over 2 ranks
    source = r.integers(0, 5, size=37).astype(np.int64)
    train_x = r.normal(size=(40, 6)).astype(np.float32)
    train_y = r.integers(0, 3, size=40)
    test_x = r.normal(size=(25, 6)).astype(np.float32)
    return data, source, train_x, train_y, test_x


def _ensemble_inputs():
    r = np.random.default_rng(6)
    data = r.normal(size=(40, 50)).astype(np.float32)
    source = r.integers(0, 5, size=40).astype(np.int64)
    idx = np.arange(32).reshape(2, 16)
    return data, source, idx, np.ones((2, 16), np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_pipeline")
    cfg = dict(data_root=DATA_ROOT, dataset=DS, output_dir=str(out), checkpoint_dir=str(out / "ck"),
               device="cpu", num_blocks=(1, 1, 1, 1), z_dim=4, batch_size=64, supervised_batch_size=16,
               limit_train_batches=1, limit_val_batches=1, dp_devices=2, resume=True, verbose=False)
    calls = [("pipeline", "pipeline", (cfg,)), ("resumed", "pipeline", (cfg,)),
             ("eval", "embed_and_knn", (_weights(), *_eval_inputs())),
             ("ensemble", "ensemble", (*_ensemble_inputs(), 2))]
    return out, pmesh.launch(W.run_all, 2, calls, device="cpu")


def test_pipeline_rank0_writes_every_file(runs):
    """Every output of the unimodal pipeline is written, by rank 0 alone; both
    ranks return the same 45 balanced accuracies."""
    out, ranks = runs
    (r0, w0, acc0, files), (r1, w1, acc1, _) = ranks[0]["pipeline"], ranks[1]["pipeline"]
    assert (r0, r1) == (0, 1)
    assert w1 == [], w1
    assert w0.count("csv") == 9 and w0.count("ckpt") == 4 and w0.count("resume") >= 6, w0
    want = {f"pretraining_{DS}_{k}_embeddings.csv" for k in ("waveform", "isi", "joint")} | \
           {f"{DS}_{k}_{what}.csv" for k in ("waveform", "isi", "joint") for what in ("knn", "embeddings")}
    assert want <= set(files), sorted(want - set(files))
    assert sorted(p.name for p in (out / "ck").glob("*.ckpt")) == sorted(
        f"{DS}_{m}_model{s}.ckpt" for m in ("wave", "time") for s in ("", "_supervised"))
    assert acc0 == acc1 and sum(len(v) for v in acc0.values()) == 45
    assert all(np.isfinite(v).all() for v in acc0.values())


def test_pipeline_resumes_on_every_rank(runs):
    """The same command again with ``resume``: every rank reloads each stage
    fit's saved state (all complete, so no epoch runs) and the results are
    the first run's; rank 1 still writes nothing."""
    _, ranks = runs
    (_, w0, acc0, _), (_, w1, acc1, _) = ranks[0]["resumed"], ranks[1]["resumed"]
    assert w1 == [] and "ckpt" in w0
    assert acc0 == acc1 == ranks[0]["pipeline"][2]


def test_sharded_embeddings_and_knn_match(runs):
    """``mesh=`` embeddings within 1e-5 of the unsharded call (37 rows over 2
    ranks: one padding row), the KNN predictions for every k equal."""
    _, ranks = runs
    e_ref, p_ref = W.embed_and_knn(None, _weights(), *_eval_inputs())
    for rank in ranks:
        e, p = rank["eval"]
        assert e.shape == e_ref.shape
        np.testing.assert_allclose(e, e_ref, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(p, p_ref)


def test_shard_replicas_fit_matches_unsharded_ensemble(runs):
    """K=2 replicas, one per rank, against the unsharded K=2 ensemble: the best
    validation losses within rtol 1.5e-2 (they are the same fits), the best
    epochs equal and every replica's best snapshot on every rank."""
    _, ranks = runs
    val, epoch, best = W.ensemble(None, *_ensemble_inputs(), 2)
    for rank in ranks:
        v, e, b = rank["ensemble"]
        np.testing.assert_allclose(v, val, rtol=1.5e-2)
        np.testing.assert_array_equal(e, epoch)
        assert len(b) == 2
        for r in range(2):
            for k in best[r]:
                np.testing.assert_allclose(b[r][k], best[r][k], rtol=1.5e-2, atol=1e-6, err_msg=k)


def test_shard_replicas_refuses_an_uneven_split():
    """K % N != 0 raises, as GSPMD's tiling rule; K/N contiguous replicas per rank."""
    mesh = [pmesh.Mesh(r, 2, torch.device("cpu"), "gloo") for r in range(2)]
    with pytest.raises(ValueError, match="3 replicas do not divide over the 2 ranks"):
        tens.shard_replicas(list(range(3)), mesh[0])
    with pytest.raises(ValueError, match="5 replicas do not divide over the 2 ranks"):
        tens.shard_replicas({"w": torch.zeros(5, 2)}, mesh[1])
    assert tens.shard_replicas(list(range(4)), mesh[1]) == [2, 3]
    assert torch.equal(tens.shard_replicas({"w": torch.arange(4.)}, mesh[0])["w"], torch.tensor([0., 1.]))
