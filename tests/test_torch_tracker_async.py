"""BestTracker's background writes (train/pipeline.py: ``flush_async``,
``wait``, ``flush``), the counterpart of the JAX tracker's.

A tracker's .ckpt is byte-equal to the per-tensor writer's of the same
snapshot, and a file written by ``flush_async`` to a synchronous ``flush``
of the same snapshot, for AdamW and for schedule-free (its sidecar too); an
error in the writer thread is re-raised by ``wait()`` and ``flush()``; the thread is
not a daemon; a second ``flush_async`` joins the first. Then one small
unimodal pipeline with ``optimizer="schedule-free"`` (num_blocks=(1, 1, 1,
1), one batch per stage, on the CPU) writes each .ckpt with empty
``optimizer_states`` and a sidecar, and finite outputs.
"""

import pathlib
import threading

import numpy as np
import pytest
import torch

from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import loop
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import pipeline as tpipe

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _fit_result(algorithm: str, seed: int = 0) -> tuple:
    """A FitResult whose best snapshot is a small cVAE after two steps of
    ``algorithm``, and its parameter names."""
    model = tcvae.unimodal_cvae_init(
        tcvae.CVAEConfig(z_dim=4, output_size=50, class_hidden_dim=3, num_blocks=(1, 1, 1, 1)),
        torch.Generator().manual_seed(seed), device="cpu")
    opt = toptim.make_optimizer(model.parameters(), 1e-3, 0.01, algorithm=algorithm)
    r = np.random.default_rng(seed)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy((r.normal(size=tuple(p.shape)) * 0.1).astype(np.float32))
        opt.step()
    sd, osd = loop.snapshot(type("TS", (), {"model": model, "optimizer": opt})())
    result = loop.FitResult(state=None, best_state_dict=sd, best_opt_state=osd, best_val_loss=1.0,
                            best_epoch=0, epochs_run=1)
    return result, tckpt.parameter_key_order(model)


@pytest.mark.parametrize("algorithm", ["adamw", "schedule-free"])
def test_flush_async_writes_the_bytes_of_flush(tmp_path, algorithm):
    result, keys = _fit_result(algorithm)
    files = {}
    for how in ("sync", "async"):
        t = tpipe.BestTracker(str(tmp_path / how / "m.ckpt"))
        assert t.update_from_fit(result, keys, (1e-3, 0.01))
        if how == "sync":
            t.flush()
        else:
            t.flush_async()
            t.wait()
        assert t._pending is None and len(t.writes) == 1
        assert set(t.writes[0]) == {"d2h_s", "convert_s", "save_s"}  # no pinned fetch on the CPU
        files[how] = sorted(p.name for p in (tmp_path / how).iterdir())
    assert files["sync"] == files["async"] == (["m.ckpt"] if algorithm == "adamw"
                                               else ["m.ckpt", "m.ckpt.sfstate"])
    for name in files["sync"]:
        assert (tmp_path / "sync" / name).read_bytes() == (tmp_path / "async" / name).read_bytes(), name
    ck = tckpt.load_lightning_ckpt(str(tmp_path / "async" / "m.ckpt"))
    assert (ck["optimizer_states"] == []) == (algorithm == "schedule-free")


def _per_tensor_ckpt(path, sd, opt_sd, keys, lr, wd):
    """The checkpoint as the writer before the one-copy fetch made it: one
    ``.cpu()`` per tensor, ``float(step)`` per entry, then torch.save."""
    import os
    from collections import OrderedDict

    state = {}
    for i, k in enumerate(keys):
        e = opt_sd["state"][i]
        state[i] = {"step": np.asarray(float(e["step"]), dtype=np.float32),
                    "exp_avg": e["exp_avg"].detach().float().cpu().numpy(),
                    "exp_avg_sq": e["exp_avg_sq"].detach().float().cpu().numpy()}
    payload = {
        "state_dict": OrderedDict(("model." + k, v.detach().cpu().clone()) for k, v in sd.items()),
        "optimizer_states": [{"state": state, "param_groups": [{
            "lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": wd, "amsgrad": False,
            "maximize": False, "foreach": None, "capturable": False, "differentiable": False,
            "fused": None, "params": list(range(len(keys)))}]}],
        "epoch": 0, "global_step": 0, "pytorch-lightning_version": "2.0.0", "hyper_parameters": {},
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def test_ckpt_bytes_equal_the_per_tensor_writer(tmp_path):
    """The one-copy fetch changes no byte of a .ckpt: a tracker's file equals
    the one the per-tensor writer made of the same snapshot."""
    result, keys = _fit_result("adamw", seed=3)
    _per_tensor_ckpt(str(tmp_path / "before" / "m.ckpt"), result.best_state_dict,
                     result.best_opt_state, keys, 1e-3, 0.01)
    t = tpipe.BestTracker(str(tmp_path / "after" / "m.ckpt"))
    t.update_from_fit(result, keys, (1e-3, 0.01))
    t.flush()
    assert (tmp_path / "before" / "m.ckpt").read_bytes() == (tmp_path / "after" / "m.ckpt").read_bytes()


def test_writer_errors_are_raised_by_wait_and_flush(tmp_path, monkeypatch):
    result, keys = _fit_result("adamw")

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_lightning_ckpt", broken)
    t = tpipe.BestTracker(str(tmp_path / "m.ckpt"))
    t.update_from_fit(result, keys, (1e-3, 0.01))
    t.flush_async()
    with pytest.raises(OSError, match="disk full"):
        t.wait()
    t.wait()  # raised once
    t.flush_async()
    with pytest.raises(OSError, match="disk full"):
        t.flush()
    assert t._pending is not None and not (tmp_path / "m.ckpt").exists()
    assert not list(tmp_path.iterdir())  # the atomic write left no temporary file


def test_writer_thread_is_not_a_daemon_and_a_second_flush_async_joins_the_first(tmp_path, monkeypatch):
    result, keys = _fit_result("adamw")
    release = threading.Event()
    order = []
    real = tpipe.BestTracker._write

    def slow(self, job, ready=None):
        order.append(("start", job[2] is keys_a))
        if job[2] is keys_a:
            assert release.wait(30)
        real(self, job, ready)
        order.append(("end", job[2] is keys_a))

    monkeypatch.setattr(tpipe.BestTracker, "_write", slow)
    t = tpipe.BestTracker(str(tmp_path / "m.ckpt"))
    t.update_from_fit(result, keys, (1e-3, 0.01))
    keys_a = t._pending[2]
    t.flush_async()
    assert t._thread is not None and not t._thread.daemon and t._thread.is_alive()
    result.best_val_loss = 0.5  # a later, better fit while the first write runs
    t.update_from_fit(result, keys, (1e-3, 0.01))
    threading.Timer(0.2, release.set).start()
    t.flush_async()  # joins the first write before starting its own
    t.wait()
    assert order == [("start", True), ("end", True), ("start", False), ("end", False)]
    assert t._pending is None and len(t.writes) == 2


def test_schedule_free_pipeline_writes_sidecars(tmp_path):
    cfg = tpipe.PipelineConfig(num_blocks=(1, 1, 1, 1), limit_train_batches=1, limit_val_batches=1,
                               device="cpu", data_root=str(REPO / "datasets"),
                               output_dir=str(tmp_path / "out"), checkpoint_dir=str(tmp_path / "ckpt"),
                               verbose=False, optimizer="schedule-free")
    trackers = {}
    results = tpipe.run_unimodal_pipeline(cfg, trackers=trackers)
    accs = [a for kind in results["balanced_accuracy"].values() for a in kind]
    assert len(accs) == 45 and np.isfinite(accs).all()
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    stems = sorted(f"{cfg.dataset}_{m}_model{s}.ckpt" for m in ("wave", "time") for s in ("", "_supervised"))
    assert names == sorted(stems + [s + ".sfstate" for s in stems])
    for key, t in trackers.items():
        ck = tckpt.load_lightning_ckpt(t.path)
        assert ck["optimizer_states"] == []
        sd = tckpt.model_state_from_ckpt(ck)
        assert all(torch.equal(sd[k], v) for k, v in t.best_state_dict.items()), key
        assert all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point())
        sf = toptim.find_schedule_free_state(t.best_opt)
        assert sf is not None and int(sf.k) >= 1
        # the sidecar restores the averaging state into a fresh optimizer
        model = tcvae.unimodal_cvae_init(
            tpipe.model_config(cfg, key.split("_")[0], results["num_class_labels"]
                               if "supervised" in key else 5), torch.Generator().manual_seed(0),
            device="cpu")
        opt = toptim.make_optimizer(model.parameters(), 1e-4, algorithm="schedule-free")
        toptim.load_schedule_free_sidecar(t.path, opt, tckpt.parameter_key_order(model))
        got = toptim.find_schedule_free_state(opt)
        assert int(got.k) == int(sf.k) and all(torch.equal(a, b) for a, b in zip(got.z, sf.z))
        assert t.wait_s >= 0 and t.writes
    for kind in ("waveform", "isi", "joint"):
        rows = (tmp_path / "out" / f"{cfg.dataset}_{kind}_embeddings.csv").read_text().splitlines()[1:]
        assert rows and all(np.isfinite([float(v) for v in r.split(",")[1:-1]]).all() for r in rows)
