"""FSDP of the port (parallel/fsdp.py) on two gloo CPU ranks, against the
data-parallel run of the same epoch (as tests/test_fsdp.py holds the JAX
package's FSDP to its replicated run): the same envelope, losses within
rtol 1e-3, atol 1e-4 and every parameter within 4.5e-3 after 2 AdamW steps;
the parameter and moment bytes a rank holds between steps; the Lightning
.ckpt written from the sharded state. Rank workers are
tests/_torch_dp_workers.py."""

import numpy as np
import pytest
import torch

import _torch_dp_workers as W
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.scripts import train_model as tcli
from hippie_tpu_torch.train import pipeline as tpipe
from test_torch_dp import ENVELOPE, _data, _weights

torch.set_num_threads(1)

# (block backend, clip, moments' dtype): the plain step, the global-norm clip
# across shards, the block kernels' seam (its gamma and beta sharded but
# already summed) and bf16 moments
CASES = [("xla", None, None), ("xla", 1.0, None), ("pallas", None, None), ("xla", None, "bfloat16")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    data, source, idx, mask, eps = _data()
    sd = _weights()
    calls = []
    for i, (block, clip, dtype) in enumerate(CASES):
        for fsdp in (False, True):
            calls.append(((i, fsdp), "epoch", ("unimodal", block, sd, data, source, idx, mask, eps, fsdp, clip,
                                               str(d / f"{i}_{int(fsdp)}.ckpt"), dtype)))
    return d, pmesh.launch(W.run_all, 2, calls, device="cpu")


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{b}-clip{c}-{t}" for b, c, t in CASES])
def test_fsdp_matches_data_parallel(runs, case):
    """The FSDP epoch's parameters, buffers and last loss within the JAX
    envelope of the data-parallel epoch's; the ranks' states bit-equal."""
    _, ranks = runs
    dp, fs = ranks[0][(case, False)], ranks[0][(case, True)]
    for k, v in fs["state"].items():
        np.testing.assert_array_equal(v, ranks[1][(case, True)]["state"][k], err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(dp["state"][k]), k
        else:
            assert np.abs(v - dp["state"][k]).max() < ENVELOPE, (k, np.abs(v - dp["state"][k]).max())
    # the FSDP run's first step is by hand, its epoch the second step
    np.testing.assert_allclose(fs["loss"][-1], dp["loss"][-1], rtol=1e-3, atol=1e-4)


def test_fsdp_rank_holds_about_half(runs):
    """Between steps a rank holds the whole parameters (one fixed storage
    each, which a CUDA graph can replay through) and its shards of the
    parameters and of both moments: at most the parameters plus 0.55x the
    replicated parameters and moments, plus the replicated leaves."""
    _, ranks = runs
    for rank in ranks:
        fs = rank[(0, True)]
        assert fs["param_bytes"] <= fs["bytes"], fs["bytes"]
        assert fs["bytes"] <= fs["param_bytes"] + 0.55 * fs["replicated_bytes"] + fs["whole_bytes"], fs["bytes"]
        assert fs["whole_bytes"] < 0.01 * fs["replicated_bytes"]


@pytest.mark.parametrize("case", [0, 3], ids=["float32", "bfloat16"])
def test_fsdp_ckpt_holds_the_gathered_state(runs, case):
    """The .ckpt rank 0 writes under FSDP: its moments are the two ranks'
    shards joined along each leaf's dim, its weights the gathered model's,
    and its layout (keys, shapes, dtypes) the data-parallel run's file."""
    d, ranks = runs
    fs = ranks[0][(case, True)]
    ck = torch.load(d / f"{case}_1.ckpt", weights_only=False)
    ck_dp = torch.load(d / f"{case}_0.ckpt", weights_only=False)
    opt, opt_dp = ck["optimizer_states"][0], ck_dp["optimizer_states"][0]
    assert opt.keys() == opt_dp.keys() and opt["param_groups"] == opt_dp["param_groups"]
    assert list(ck["state_dict"]) == list(ck_dp["state_dict"])
    for k, v in ck["state_dict"].items():
        assert v.shape == ck_dp["state_dict"][k].shape and v.dtype == ck_dp["state_dict"][k].dtype, k
        np.testing.assert_array_equal(np.asarray(v), fs["state"][k.removeprefix("model.")], err_msg=k)
    assert opt["state"].keys() == opt_dp["state"].keys()
    for i, st in opt["state"].items():
        dim = fs["dims"][i]
        for m in ("exp_avg", "exp_avg_sq"):
            assert st[m].shape == opt_dp["state"][i][m].shape and st[m].dtype == opt_dp["state"][i][m].dtype
            whole = fs["moments"][i][m]
            np.testing.assert_array_equal(np.asarray(st[m], np.float32), whole, err_msg=f"{i} {m}")
            if dim is not None:
                joined = np.concatenate([r[(case, True)]["shards"][i][m] for r in ranks], axis=dim)
                np.testing.assert_array_equal(whole, joined, err_msg=f"{i} {m}")


def test_fsdp_without_dp_devices_raises():
    """JAX's refusal, from the CLI's flags and from the pipeline's config."""
    with pytest.raises(ValueError, match=r"--fsdp requires --dp-devices > 1 \(a device mesh\)"):
        tcli.config_from_args(tcli.build_parser().parse_args(["--fsdp", "--device", "cpu"]))
    with pytest.raises(ValueError, match=r"--fsdp requires --dp-devices > 1 \(a device mesh\)"):
        tpipe._dp_shardings(tpipe.PipelineConfig(fsdp=True, dp_devices=1, device="cpu"))
