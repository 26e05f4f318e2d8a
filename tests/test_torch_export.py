"""A checkpoint's geometry and model (hippie_tpu_torch/export.py) against
hippie_tpu/export.py.

``infer_unimodal_config`` and ``infer_multimodal_config`` read the same
geometry as the JAX functions from checkpoints written by either package, at
a non-default geometry (z=4, 7 sources, 3 classes, class width 3, blocks
(1, 2, 1, 1)). ``load_model_from_ckpt`` rebuilds a JAX-written checkpoint
whose eval-mode forward is within 1e-5 of the JAX model's from its own
loader (encoded, mu, logvar and decoded, the same inputs; both sides in
float32 without reduced-precision products, as the embedding tests). A
checkpoint without geometry takes ``fallback_config`` or raises the JAX
function's ValueError; ``multimodal=None`` detects a joint checkpoint.
"""

import jax
import numpy as np
import pytest
import torch

from hippie_tpu import export as jexport
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu_torch import export as texport
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

GEOMETRY = dict(z_dim=4, class_hidden_dim=3, num_sources=7, num_classes=3, num_blocks=(1, 2, 1, 1))
UNI = dict(GEOMETRY, output_size=100)
N = 12


def _templates(init, cfg):
    """The JAX init's (params, state) shapes in its own key order, without
    running it."""
    seen = []
    jax.eval_shape(lambda: seen.append(init(jax.random.PRNGKey(0), cfg)))

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else (
            jax.ShapeDtypeStruct(t.shape, t.dtype))

    return [shapes(t) for t in seen[0]]


def _port(multimodal: bool, seed: int, **kw):
    if multimodal:
        return tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(**{**GEOMETRY, **kw}),
                                          torch.Generator().manual_seed(seed), device="cpu")
    return tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**{**UNI, **kw}), torch.Generator().manual_seed(seed),
                                    device="cpu")


def _jax_file(tmp_path, multimodal: bool, seed: int) -> str:
    """A .ckpt written by hippie_tpu's save_lightning_ckpt (weights drawn by
    a seeded port model, the running statistics moved off their init)."""
    model = _port(multimodal, seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if "running_" in k:
                v.add_(torch.rand(v.shape, generator=torch.Generator().manual_seed(seed)))
    init, cfg = ((jcvae.multimodal_cvae_init, jcvae.MultiModalConfig(**GEOMETRY)) if multimodal
                 else (jcvae.unimodal_cvae_init, jcvae.CVAEConfig(**UNI)))
    params, bn, _, skipped = jckpt.from_torch_state_dict(model.state_dict(), *_templates(init, cfg),
                                                         prefix="")
    assert not skipped
    path = str(tmp_path / f"jax_{'joint' if multimodal else 'uni'}.ckpt")
    jckpt.save_lightning_ckpt(path, params, bn)
    return path


def _port_file(tmp_path, multimodal: bool, seed: int) -> str:
    path = str(tmp_path / f"port_{'joint' if multimodal else 'uni'}.ckpt")
    tckpt.save_lightning_ckpt(path, _port(multimodal, seed).state_dict())
    return path


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(N, 50)).astype(np.float32), r.normal(size=(N, 100)).astype(np.float32),
            r.integers(0, 7, size=N).astype(np.int32))


@pytest.mark.parametrize("writer", [_jax_file, _port_file], ids=["jax_ckpt", "port_ckpt"])
@pytest.mark.parametrize("multimodal", [False, True], ids=["unimodal", "joint"])
def test_infer_config_matches_jax(tmp_path, writer, multimodal):
    payload = tckpt.load_lightning_ckpt(writer(tmp_path, multimodal, 1))
    sd = payload["state_dict"]
    if multimodal:
        got, ref = texport.infer_multimodal_config(sd), jexport.infer_multimodal_config(sd)
        assert got == tcvae.MultiModalConfig(**GEOMETRY)
    else:
        got, ref = texport.infer_unimodal_config(sd), jexport.infer_unimodal_config(sd)
        assert got == tcvae.CVAEConfig(**UNI)
    assert tuple(got) == tuple(ref) and got._fields == ref._fields


def _jax_forward(params, bn, cfg, wave, isi, source, multimodal):
    if multimodal:
        out, _ = jax.jit(lambda p, s: jcvae.multimodal_cvae_apply(p, s, wave, isi, source))(params, bn)
    else:
        out, _ = jax.jit(lambda p, s: jcvae.unimodal_cvae_apply(p, s, isi, source))(params, bn)
    return [np.asarray(x) for x in out]


def _port_forward(model, wave, isi, source, multimodal):
    t = torch.from_numpy
    with torch.no_grad():
        out = (model(t(wave), t(isi), t(source).long()) if multimodal
               else model(t(isi), t(source).long()))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("multimodal", [False, True], ids=["unimodal", "joint"])
def test_load_model_from_jax_ckpt_forward_matches_jax(tmp_path, multimodal):
    path = _jax_file(tmp_path, multimodal, 2)
    model, cfg = texport.load_model_from_ckpt(path, device="cpu")
    params, bn, jcfg = jexport.load_model_from_ckpt(path)
    assert isinstance(model, tcvae.MultiModalCVAE if multimodal else tcvae.UnimodalCVAE)
    assert not model.training and tuple(cfg) == tuple(jcfg)
    wave, isi, source = _inputs()
    got = _port_forward(model, wave, isi, source, multimodal)
    ref = _jax_forward(params, bn, jcfg, wave, isi, source, multimodal)
    assert len(got) == len(ref) == (5 if multimodal else 4)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_fallback_config_without_a_class_embedding(tmp_path):
    """A checkpoint without its class embedding (the reference's inference
    heal removes it) has no geometry to read: the fallback config builds the
    model, which keeps a fresh class embedding and otherwise equals the JAX
    loader's with the same fallback."""
    payload = tckpt.load_lightning_ckpt(_jax_file(tmp_path, False, 3))
    del payload["state_dict"]["model.class_embedding.weight"]
    fallback = tcvae.CVAEConfig(**UNI)
    model, cfg = texport.load_model_from_ckpt(payload, fallback_config=fallback, device="cpu")
    params, bn, jcfg = jexport.load_model_from_ckpt(payload, fallback_config=jcvae.CVAEConfig(**UNI))
    assert cfg is fallback and tuple(jcfg) == tuple(cfg)
    wave, isi, source = _inputs(1)
    for a, b in zip(_port_forward(model, wave, isi, source, False),
                    _jax_forward(params, bn, jcfg, wave, isi, source, False)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("loader", [texport.load_model_from_ckpt, jexport.load_model_from_ckpt],
                         ids=["port", "jax"])
def test_no_geometry_and_no_fallback_raises(tmp_path, loader):
    payload = tckpt.load_lightning_ckpt(_port_file(tmp_path, False, 4))
    del payload["state_dict"]["model.z_mean.weight"]
    with pytest.raises(ValueError, match="could not infer model geometry"):
        loader(payload)


@pytest.mark.parametrize("multimodal", [False, True], ids=["unimodal", "joint"])
def test_auto_detects_a_joint_checkpoint(tmp_path, multimodal):
    path = _port_file(tmp_path, multimodal, 5)
    model, cfg = texport.load_model_from_ckpt(path, device="cpu")
    assert isinstance(cfg, tcvae.MultiModalConfig if multimodal else tcvae.CVAEConfig)
    assert isinstance(model, tcvae.MultiModalCVAE if multimodal else tcvae.UnimodalCVAE)
    ref = _port(multimodal, 5).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    # told the wrong family, the geometry cannot be read
    with pytest.raises(ValueError, match="could not infer"):
        texport.load_model_from_ckpt(path, multimodal=not multimodal, device="cpu")
