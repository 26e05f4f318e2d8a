"""FSDP under the device fit loop and with schedule-free, and the sharded
K-replica resume, on two gloo CPU ranks (tests/_torch_dp_workers.py).

- An FSDP unimodal stage fit (pipeline.fit_unimodal_stage, 2 epochs) on the
  device loop equals the same fit on the host loop bit for bit, with AdamW
  (clipped at 1.0: the clip sums the shards' squares over the ranks) and
  with schedule-free: losses, best epoch, final state, the gathered
  optimizer state and the best snapshot.
- One schedule-free epoch with FSDP against the data-parallel one, in
  test_torch_fsdp.py's envelope (losses rtol 1e-3, atol 1e-4; every
  parameter, every leaf of the gathered state, and the x iterate within
  4.5e-3); the ranks bit-equal; the ``.sfstate`` sidecar with the
  data-parallel run's keys, shapes and dtypes; x whole on every rank from
  both maybe_eval_params and evaluated_at_x; the stage fork over the shards
  (pipeline._sf_fork_state) equal bit for bit to the unsharded fork from the
  same gathered state.
- ``device_fit_ensemble(mesh=, resume_dir=)`` at K=2, one replica per rank:
  stopped after one of two epochs and resumed from fresh replicas, it equals
  the uninterrupted sharded fit bit for bit; it resumes an unsharded fit's
  file the same way; and its own file resumes in an unsharded fit (no epoch
  left) to every replica's state and best snapshot.
"""

import pickle
import shutil

import numpy as np
import pytest
import torch

import _torch_dp_workers as W
from hippie_tpu_torch.parallel import mesh as pmesh
from test_torch_dp import ENVELOPE, _data, _weights

torch.set_num_threads(1)

K = 2


def _ensemble_inputs():
    r = np.random.default_rng(6)
    data = r.normal(size=(40, 50)).astype(np.float32)
    source = r.integers(0, 5, size=40).astype(np.int64)
    return data, source, np.arange(32, 40).reshape(1, 8), np.ones((1, 8), np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_device")
    sd = _weights()
    data, source, idx, mask, eps = _data()
    stage_data = np.random.default_rng(8).normal(size=(40, 50)).astype(np.float32)
    stage_source = np.zeros(40, np.int64)
    ens = _ensemble_inputs()
    unsharded_dir = str(d / "unsharded")
    W._ensemble_fit(None, *ens, K, 1, unsharded_dir)  # the unsharded fit's file after one epoch
    calls = [((fit_loop, opt), "fsdp_stage", (sd, stage_data, stage_source, fit_loop, opt, clip))
             for fit_loop in ("host", "device") for opt, clip in (("adamw", 1.0), ("schedule-free", None))]
    calls += [(("sf", fsdp), "sf_epoch", (sd, data[0], source, idx, mask, eps, fsdp, str(d / f"sf_{int(fsdp)}.ckpt")))
              for fsdp in (False, True)]
    calls.append(("ensemble", "ensemble_resume", (*ens, K, str(d / "sharded"), unsharded_dir)))
    ranks = pmesh.launch(W.run_all, 2, calls, device="cpu")
    yield d, ranks
    shutil.rmtree(d, ignore_errors=True)


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("opt", ["adamw", "schedule-free"])
def test_fsdp_device_loop_equals_the_host_loop(runs, opt):
    """The FSDP stage fit on the device loop is the host loop's, bit for bit,
    on both ranks."""
    _, ranks = runs
    for rank in ranks:
        dev, host = rank[("device", opt)], rank[("host", opt)]
        _assert_equal_trees({k: v for k, v in dev.items() if k != "graphs"},
                            {k: v for k, v in host.items() if k != "graphs"})
        assert dev["losses"][3] == 2 and np.all(np.isfinite(dev["losses"][0]))
        assert "captured" in dev["graphs"] and not host["graphs"]  # the device loop ran
    _assert_equal_trees(ranks[0][("device", opt)]["state"], ranks[1][("device", opt)]["state"])


def test_fsdp_schedule_free_matches_data_parallel(runs):
    """The FSDP schedule-free epoch in the data-parallel one's envelope, its
    gathered state (z, exp_avg_sq, k, weight_sum, lr_max) in the replicated
    layout, x whole on every rank."""
    _, ranks = runs
    dp, fs = ranks[0][("sf", False)], ranks[0][("sf", True)]
    _assert_equal_trees(fs["state"], ranks[1][("sf", True)]["state"])
    _assert_equal_trees(fs["x"], ranks[1][("sf", True)]["x"])
    np.testing.assert_allclose(fs["loss"], dp["loss"], rtol=1e-3, atol=1e-4)
    for k, v in fs["state"].items():
        if not k.endswith("num_batches_tracked"):
            assert np.abs(v - dp["state"][k]).max() < ENVELOPE, k
    for k, v in fs["x"].items():
        assert v.shape == dp["x"][k].shape and np.abs(v - dp["x"][k]).max() < ENVELOPE, k
        np.testing.assert_array_equal(fs["x_model"][k], v, err_msg=k)  # evaluated_at_x holds the same x
    assert fs["opt"]["param_groups"][0].keys() == dp["opt"]["param_groups"][0].keys()
    assert fs["opt"]["state"].keys() == dp["opt"]["state"].keys()
    for i, st in fs["opt"]["state"].items():
        assert sorted(st) == sorted(dp["opt"]["state"][i]) == ["exp_avg_sq", "z"]
        for name, v in st.items():
            assert v.shape == dp["opt"]["state"][i][name].shape, (i, name)
            assert np.abs(v - dp["opt"]["state"][i][name]).max() < ENVELOPE, (i, name)
    for name in ("k", "weight_sum", "lr_max"):
        np.testing.assert_array_equal(fs["opt"]["param_groups"][0][name], dp["opt"]["param_groups"][0][name])


def test_fsdp_sidecar_has_the_data_parallel_layout(runs):
    d, _ = runs
    with open(d / "sf_1.ckpt.sfstate", "rb") as f:
        fs = pickle.load(f)
    with open(d / "sf_0.ckpt.sfstate", "rb") as f:
        dp = pickle.load(f)
    assert fs.keys() == dp.keys() and (fs["k"], type(fs["weight_sum"])) == (dp["k"], type(dp["weight_sum"]))
    for name in ("z", "exp_avg_sq"):
        assert list(fs[name]) == list(dp[name])
        for k, v in fs[name].items():
            assert v.shape == dp[name][k].shape and v.dtype == dp[name][k].dtype, (name, k)


def test_schedule_free_stage_fork_over_the_shards(runs):
    """The fork under FSDP (over each rank's shards, then gathered) equals
    the unsharded fork from the gathered state, bit for bit."""
    _, ranks = runs
    for rank in ranks:
        forks = rank[("sf", True)]["forks"]
        _assert_equal_trees(forks["sharded"], forks["unsharded"])


def test_sharded_replicas_resume(runs):
    """Stopped and resumed, and resumed from an unsharded fit's file: the
    uninterrupted sharded fit, bit for bit, on both ranks."""
    _, ranks = runs
    for rank in ranks:
        got = rank["ensemble"]
        assert got["full"]["epochs_run"] == 2
        _assert_equal_trees(got["resumed"], got["full"])
        _assert_equal_trees(got["from_unsharded"], got["full"])


def test_unsharded_fit_reads_the_sharded_payload(runs):
    """The file the sharded fit's rank 0 wrote after its last epoch holds
    every replica in the unsharded layout: an unsharded fit resumes it (no
    epoch left) to each rank's replicas and every best snapshot."""
    d, ranks = runs
    res = W.ensemble_summary(W._ensemble_fit(None, *_ensemble_inputs(), K, 2, str(d / "sharded")))
    full = ranks[0]["ensemble"]["full"]
    assert res["epochs_run"] == 2
    for name in ("best_val", "best_epoch", "best"):
        _assert_equal_trees(res[name], full[name])
    for r in range(K):
        _assert_equal_trees(res["models"][r], ranks[r]["ensemble"]["full"]["models"][0])
        _assert_equal_trees(res["opts"][r], ranks[r]["ensemble"]["full"]["opts"][0])
