"""hippie_tpu_torch's data path against hippie_tpu's on the CPU.

Raw CSV ingestion on every dataset under datasets/ (widths 40-352 columns),
the leave-target-out pool names, resampling coefficients, preprocessing in
both ``normalize`` modes, the batch plan's padded tail, and the assembled
pretraining pool. Ingestion and plans must be equal; preprocessing is a float32
matmul in two frameworks, held to rtol 1e-6 / atol 1e-6 (outputs of unit
scale, sums of at most 352 products).
"""

import pathlib

import numpy as np
import pytest
import torch

from hippie_tpu.data import device_data as jdd
from hippie_tpu.data import registry as jreg
from hippie_tpu.ops import preprocess as jpre
from hippie_tpu.ops import resample as jres
from hippie_tpu.train import pipeline as jpipe
from hippie_tpu_torch.data import device_data as tdd
from hippie_tpu_torch.data import registry as treg
from hippie_tpu_torch.ops import preprocess as tpre
from hippie_tpu_torch.ops import resample as tres
from hippie_tpu_torch.train import pipeline as tpipe

torch.set_num_threads(1)

DATA_ROOT = str(pathlib.Path(__file__).resolve().parent.parent / "datasets")
NAMES = sorted(treg.DATASET_SOURCE_IDS)


def test_registry_constants_match_jax():
    assert treg.DATASET_SOURCE_IDS == jreg.DATASET_SOURCE_IDS
    assert treg.NUM_SOURCES == jreg.NUM_SOURCES


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("target", NAMES)
def test_pretrain_pool_matches_jax(target, strict):
    assert (treg.pretrain_pool(target, strict_leakage_guard=strict)
            == jreg.pretrain_pool(target, strict_leakage_guard=strict))


@pytest.mark.parametrize("name", NAMES)
def test_load_raw_matches_jax(name):
    try:
        ref = jreg.load_raw(DATA_ROOT, name)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            treg.load_raw(DATA_ROOT, name)
        return
    for kwargs in ({}, {"dropna": True, "drop_index_column": True}):
        ref = jreg.load_raw(DATA_ROOT, name, **kwargs)
        got = treg.load_raw(DATA_ROOT, name, **kwargs)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("in_len", [40, 50, 81, 100, 352])
def test_interp_matrix_matches_jax(in_len):
    for out_len in (50, 100):
        np.testing.assert_array_equal(tres.interp_matrix(in_len, out_len),
                                      jres.interp_matrix(in_len, out_len))


@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_pair_matches_jax(normalize):
    wf, isi = jreg.load_raw(DATA_ROOT, "cellexplorer-celltype")
    ref = jpre.preprocess_pair(wf, isi, normalize=normalize)
    got = tpre.preprocess_pair(wf, isi, normalize=normalize, device="cpu")
    for a, b in zip(got, ref):
        assert a.device.type == "cpu" and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 415])
def test_batch_plan_matches_jax(n):
    indices = np.arange(100, 100 + n)
    ref = jdd.batch_plan(indices, 32, shuffle=False)
    got = tdd.batch_plan(indices, 32, shuffle=False)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_shuffled_plan_pads_with_its_own_last_real_index():
    idx, mask = tdd.batch_plan(np.arange(2975), 512, shuffle=True,
                               generator=torch.Generator().manual_seed(0))
    assert idx.shape == mask.shape == (6, 512)
    assert mask[-1].sum() == 415 and mask[:-1].all()
    real = idx[mask > 0]
    np.testing.assert_array_equal(np.sort(real), np.arange(2975))
    assert (idx[-1, 415:] == idx[-1, 414]).all()
    with pytest.raises(ValueError):
        tdd.batch_plan(np.arange(5), 4, shuffle=True)


def test_train_val_split_partitions():
    tr, va = tdd.train_val_split(2975, 0.8, torch.Generator().manual_seed(0))
    assert len(tr) == int(0.8 * 2975) and len(va) == 2975 - len(tr)
    np.testing.assert_array_equal(np.sort(np.concatenate([tr, va])), np.arange(2975))


def test_pretrain_pool_arrays_match_jax():
    """The cellexplorer-celltype pool: 2,975 rows from four datasets
    (allenscope-neuropixel has no waveforms and is skipped on both sides)."""
    ref = jpipe.load_pretrain_pool(jpipe.PipelineConfig(data_root=DATA_ROOT, verbose=False))
    got = tpipe.load_pretrain_pool(tpipe.PipelineConfig(data_root=DATA_ROOT, verbose=False,
                                                        device="cpu"))
    assert len(got) == len(ref) == 2975
    np.testing.assert_array_equal(got.source.numpy(), np.asarray(ref.source))
    assert got.source.dtype == torch.int64
    for a, b in ((got.wave, ref.wave), (got.isi, ref.isi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
