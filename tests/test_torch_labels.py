"""Labels, metadata, balanced sampling and the synthetic dataset:
hippie_tpu_torch against hippie_tpu.

Every comparison here is exact: encoded labels, classes, index streams,
splits, file bytes and the arrays both packages' loaders read.
"""

import os

import numpy as np
import pytest
import torch

from hippie_tpu.data import registry as jreg
from hippie_tpu.data import sampling as jsamp
from hippie_tpu.data import synth as jsynth
from hippie_tpu_torch.data import registry as treg
from hippie_tpu_torch.data import sampling as tsamp
from hippie_tpu_torch.data import synth as tsynth

torch.set_num_threads(1)

DATA_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "datasets")


def _same_encoding(got, ref):
    (labels, le), (ref_labels, ref_le) = got, ref
    assert labels.dtype == ref_labels.dtype == np.int64
    np.testing.assert_array_equal(labels, ref_labels)
    assert le.classes_.dtype == ref_le.classes_.dtype
    np.testing.assert_array_equal(le.classes_, ref_le.classes_)


@pytest.mark.parametrize("labels", [["b", "a", "c", "a"], [3, 1, 1, 7], [2.5, 0.5, 2.5]])
def test_label_encoder_matches_jax(labels):
    le, ref = treg.LabelEncoder.fit(labels), jreg.LabelEncoder.fit(labels)
    np.testing.assert_array_equal(le.classes_, ref.classes_)
    np.testing.assert_array_equal(le.transform(labels), ref.transform(labels))
    codes = le.transform(labels)
    np.testing.assert_array_equal(le.inverse_transform(codes), ref.inverse_transform(codes))
    np.testing.assert_array_equal(le.inverse_transform(codes), np.asarray(labels))


def test_shipped_labels_take_the_last_column():
    """cellexplorer-celltype's labels.csv has columns ",0" (quirk Q5): the
    fallback to the last non-index column, 4 classes."""
    got = treg.load_supervised_labels(DATA_ROOT, "cellexplorer-celltype")
    _same_encoding(got, jreg.load_supervised_labels(DATA_ROOT, "cellexplorer-celltype"))
    labels, le = got
    assert le.classes_.tolist() == ["PV", "Pyra", "SST", "VIP"]
    assert np.bincount(labels).tolist() == [219, 44, 115, 14]


@pytest.mark.parametrize("case", ["label_column", "other_column", "integer_labels", "missing_file"])
def test_supervised_labels_match_jax(tmp_path, case):
    column = "label" if case != "other_column" else "celltype"
    tsynth.make_dataset(str(tmp_path), "ds", n=37, num_classes=4, seed=5, label_column=column)
    path = tmp_path / "ds" / "labels.csv"
    if case == "integer_labels":
        path.write_text(path.read_text().replace("type", ""))
    if case == "missing_file":
        path.unlink()
    got = treg.load_supervised_labels(str(tmp_path), "ds")
    _same_encoding(got, jreg.load_supervised_labels(str(tmp_path), "ds"))
    if case == "missing_file":
        assert not got[0].any() and len(got[0]) == 37
    if case == "integer_labels":
        assert got[1].classes_.dtype == np.int64


@pytest.mark.parametrize("seed", [0, 42, 7])
@pytest.mark.parametrize("target_count", [None, 40])
def test_balanced_indices_bit_equal(seed, target_count):
    labels = np.random.default_rng(seed).choice([3, 0, 2], size=61, p=[0.6, 0.3, 0.1])
    got = tsamp.balanced_indices(labels, seed=seed, target_count=target_count)
    ref = jsamp.balanced_indices(labels, seed=seed, target_count=target_count)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tsamp.balanced_indices(labels, seed=seed, target_count=3)


def test_make_dataset_bytes_and_loaders_match_jax(tmp_path):
    """The csv writer writes pandas' bytes; both packages' loaders read the
    same arrays from it (index column kept as feature 0, quirk Q4)."""
    kw = dict(n=29, wave_width=31, isi_width=40, num_classes=3, seed=11, with_metadata=True)
    tsynth.make_dataset(str(tmp_path / "t"), "ds", **kw)
    jsynth.make_dataset(str(tmp_path / "j"), "ds", **kw)
    names = sorted(os.listdir(tmp_path / "j" / "ds"))
    assert names == sorted(os.listdir(tmp_path / "t" / "ds")) == [
        "isi_dist.csv", "labels.csv", "metadata.csv", "waveforms.csv"]
    for name in names:
        assert (tmp_path / "t" / "ds" / name).read_bytes() == (tmp_path / "j" / "ds" / name).read_bytes()
    for dropna in (False, True):
        got = treg.load_raw(str(tmp_path / "t"), "ds", dropna=dropna)
        ref = jreg.load_raw(str(tmp_path / "t"), "ds", dropna=dropna)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (29, 32) and got[1].shape == (29, 41)


def test_chip_finetune_split_matches_jax(tmp_path):
    """The earliest-10-times rule on make_dataset(with_metadata=True), and on
    rows whose times repeat and run out of order."""
    tsynth.make_dataset(str(tmp_path), "chip-ds", n=40, seed=2, with_metadata=True)
    meta = treg.load_metadata(str(tmp_path), "chip-ds")
    assert len(meta) == 40 and set(meta[0]) == {"label", "datetime"}
    got = treg.chip_finetune_split(meta)
    ref = jreg.chip_finetune_split(jreg.load_metadata(str(tmp_path), "chip-ds"))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0].tolist() == list(range(10))

    path = tmp_path / "chip-ds" / "metadata.csv"
    rows = path.read_text().splitlines()
    r = np.random.default_rng(0)
    stamps = [f"2024-0{1 + i % 3}-0{1 + i % 5} 0{r.integers(0, 3)}:{r.integers(0, 2)}0:0{i % 4}"
              for i in range(len(rows) - 1)]
    path.write_text("\n".join([rows[0]] + [f"{i % 3},{s}" for i, s in enumerate(stamps)]) + "\n")
    got = treg.chip_finetune_split(treg.load_metadata(str(tmp_path), "chip-ds"))
    ref = jreg.chip_finetune_split(jreg.load_metadata(str(tmp_path), "chip-ds"))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert 10 <= len(got[0]) < 40
    assert treg.load_metadata(str(tmp_path), "no-such-dataset") is None
