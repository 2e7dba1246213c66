"""The port's Loader, samplers and record helpers against the JAX package's.

Batch orders, batches and the device-resident dataset are compared exactly:
the port keeps the JAX package's seeds, so nothing but identical arrays is
expected. The device dataset runs on the CPU here (``device="cpu"``)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.data import samplers as tsamp
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.data import samplers as jsamp
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MCFG = ModelConfig(num_encoder_layers=2, num_decoder_layers=2, ffn_dim=64)
TCFG = tconfig.ModelConfig(num_encoder_layers=2, num_decoder_layers=2, ffn_dim=64)


def _records(n: int = 21, seed: int = 5):
    """JAX records and the same records as the port's dataclass; one record
    that fails featurization."""
    jrecs = jdp.synthetic_dataset(n, seed=seed)
    jrecs[4] = dataclasses.replace(jrecs[4], smiles="C1CC")  # unclosed ring
    return jrecs, [tdp.SampleRecord(**dataclasses.asdict(r)) for r in jrecs]


def _assert_batches_equal(a, b):
    for name, x, y in zip(b.inputs._fields, a.inputs, b.inputs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    np.testing.assert_array_equal(np.asarray(a.trg_tokens), np.asarray(b.trg_tokens))
    np.testing.assert_array_equal(np.asarray(a.trg_fp), np.asarray(b.trg_fp))


def test_synthetic_and_augmented_records_match_jax():
    jrecs = jdp.synthetic_dataset(12, seed=3)
    trecs = tdp.synthetic_dataset(12, seed=3)
    for a, b in zip(jrecs, trecs):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(da.pop("ir"), db.pop("ir"))
        assert da == db
    ja = jdp.augment_records(jrecs, 3, seed=2)
    ta = tdp.augment_records(trecs, 3, seed=2)
    assert [(r.sample_id, r.smiles) for r in ja] == [(r.sample_id, r.smiles) for r in ta]
    assert len(ta) > len(trecs)
    assert tdp.augment_records(trecs, 1) == trecs


@pytest.mark.parametrize("strategy", ["shuffle", "weight_sorted", "tanimoto"])
@pytest.mark.parametrize("epoch", [0, 3])
def test_sampler_orders_match_jax(strategy, epoch):
    smiles = [r.smiles for r in jdp.synthetic_dataset(40, seed=1)] + ["not a smiles"]
    a = jsamp.epoch_order(strategy, smiles, 8, 7, epoch)
    b = tsamp.epoch_order(strategy, smiles, 8, 7, epoch)
    np.testing.assert_array_equal(a, b)
    assert sorted(b.tolist()) == list(range(len(smiles)))


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("augment", [1, 2])
def test_loader_epochs_match_jax(drop_remainder, augment):
    """Two epochs of host batches, identical to the JAX Loader's; then the
    device dataset with ``gather_rows`` gives the same batches (the failing
    record is dropped up front there, so its batches are compared against a
    Loader over the featurizable records)."""
    jrecs, trecs = _records()
    jrecs = jdp.augment_records(jrecs, augment, seed=1)
    trecs = tdp.augment_records(trecs, augment, seed=1)
    jopts = jdp.FeaturizeOptions(use_given_smiles_form=augment > 1)
    topts = tdp.FeaturizeOptions(use_given_smiles_form=augment > 1)
    jl = jdp.Loader(jrecs, MCFG, batch_size=4, opts=jopts, seed=3, drop_remainder=drop_remainder)
    tl = tdp.Loader(trecs, TCFG, batch_size=4, opts=topts, seed=3, drop_remainder=drop_remainder)
    assert len(tl) == len(jl)
    for epoch in (0, 1):
        jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jb) == len(tb) > 0
        for a, b in zip(tb, jb):
            _assert_batches_equal(a, b)

    dd = tl.device_dataset("cpu")
    assert dd.inputs.src_1h.dtype == torch.float16 and dd.trg_tokens.dtype == torch.uint8
    jdd = jl.device_dataset()
    _assert_batches_equal(tdp.TrainBatch(*dd), jax.tree.map(np.asarray, jdd))
    kept = [r for r in trecs if r.smiles != "C1CC"]
    ref = tdp.Loader(kept, TCFG, batch_size=4, opts=topts, seed=3, drop_remainder=drop_remainder)
    for epoch in (0, 1):
        rows = list(tl.epoch_row_batches(epoch))
        np.testing.assert_array_equal(
            np.concatenate(rows), np.concatenate(list(jl.epoch_row_batches(epoch))))
        host = list(ref.epoch(epoch))
        assert len(rows) == len(host)
        for idx, want in zip(rows, host):
            got = tdp.gather_rows(dd, idx)
            assert got.inputs.src_1h.dtype == torch.float32 and got.trg_tokens.dtype == torch.int32
            for x, y in zip(got.inputs, want.inputs):
                assert np.allclose(x.numpy(), np.asarray(y), atol=2e-3, rtol=1e-3)  # float16 storage
            np.testing.assert_array_equal(got.trg_tokens.numpy(), want.trg_tokens)
            np.testing.assert_array_equal(got.trg_fp.numpy(), want.trg_fp)


def test_compact_storage_matches_jax_and_gather_restores_it():
    jrecs, trecs = _records(9)
    feats = [f for f in (jdp.featurize(r, MCFG) for r in jrecs) if f is not None]
    jc = jdp.Loader.compact_train_batch(jdp.collate(feats))
    tc = tdp.Loader.compact_train_batch(tdp.collate(feats))
    for name, a, b in zip(jc.inputs._fields, tc.inputs, jc.inputs):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    dd = tdp.to_device(tc, "cpu")
    ref = jax.tree.map(np.asarray, jdp.gather_rows(jax.tree.map(jax.numpy.asarray, jc),
                                                   jax.numpy.asarray([3, 0, 5])))
    _assert_batches_equal(tdp.gather_rows(dd, np.array([3, 0, 5])), ref)
    bad = tdp.collate(feats)._replace(trg_tokens=np.full((len(feats), 64), 300))
    with pytest.raises(ValueError, match="uint8"):
        tdp.Loader.compact_train_batch(bad)


def test_stochastic_featurization_keeps_the_host_path():
    _, trecs = _records(8)
    tl = tdp.Loader(trecs, TCFG, batch_size=4, opts=tdp.FeaturizeOptions(blank_percentage=0.5))
    assert tl.device_dataset("cpu") is None
    assert len(list(tl.epoch(0))) == 1
    with pytest.raises(RuntimeError, match="device_dataset"):
        next(tl.epoch_row_batches(0))


# ---------------------------------------------------------------------------
# the featurized-dataset disk cache (MMT_FEATURE_CACHE) and the size cap
# ---------------------------------------------------------------------------

OPTION_SETS = {
    "default": {},
    "augmented": dict(use_given_smiles_form=True, use_ir=False),
    "noise_pool": dict(hsqc_noise_pool=[(1.5, 30.0), (7.2, 128.5)]),
}


@pytest.mark.parametrize("opts", sorted(OPTION_SETS))
def test_features_digest_matches_jax(opts):
    """The port's digest is the JAX package's for the same records, model
    layout and options (the cache is shared), and moves with each of them."""
    jrecs, trecs = _records(9)
    kw = OPTION_SETS[opts]
    jl = jdp.Loader(jrecs, MCFG, batch_size=4, opts=jdp.FeaturizeOptions(**kw))
    tl = tdp.Loader(trecs, TCFG, batch_size=4, opts=tdp.FeaturizeOptions(**kw))
    assert tl.features_digest() == jl.features_digest()
    assert tdp.FEATURIZE_SCHEMA_VERSION == jdp.FEATURIZE_SCHEMA_VERSION
    other = tdp.Loader(trecs[:-1], TCFG, batch_size=4, opts=tdp.FeaturizeOptions(**kw))
    wider = tdp.Loader(trecs, tconfig.ModelConfig(spectrum_points=72), batch_size=4,
                       opts=tdp.FeaturizeOptions(**kw))
    assert len({tl.features_digest(), other.features_digest(), wider.features_digest()}) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_cache_is_shared_with_jax(tmp_path, monkeypatch, writer):
    """A cache file written by one package is found and read by the other,
    and gives exactly the reader's own featurization (kept rows included);
    the reader writes no second file."""
    jrecs, trecs = _records(9)
    monkeypatch.setenv("MMT_FEATURE_CACHE", str(tmp_path))
    own = tdp.Loader(trecs, TCFG, batch_size=4)._featurize_records()
    if writer == "jax":
        jdp.Loader(jrecs, MCFG, batch_size=4).device_dataset()
    else:
        tdp.Loader(trecs, TCFG, batch_size=4).device_dataset("cpu")
    files = sorted(tmp_path.glob("mmt_features_*.npz"))
    assert len(files) == 1
    if writer == "jax":
        tl = tdp.Loader(trecs, TCFG, batch_size=4)
        dd = tl.device_dataset("cpu")
        _assert_batches_equal(tdp.TrainBatch(*dd), own[0])
        assert tl._device_kept_smiles == [trecs[int(i)].smiles for i in own[1]]
    else:
        jl = jdp.Loader(jrecs, MCFG, batch_size=4)
        jdd = jl.device_dataset()
        _assert_batches_equal(jax.tree.map(np.asarray, jdd), own[0])
        assert jl._device_kept_smiles == [trecs[int(i)].smiles for i in own[1]]
    assert sorted(tmp_path.glob("mmt_features_*.npz")) == files


def test_device_dataset_cap_from_the_environment(monkeypatch):
    """``MMT_DEVICE_DATASET_GB`` is the default cap: a set over it falls back
    to the host path; an explicit ``max_bytes`` still wins."""
    _, trecs = _records(9)
    monkeypatch.setenv("MMT_DEVICE_DATASET_GB", "1e-6")  # about 1 KiB
    assert tdp.Loader(trecs, TCFG, batch_size=4).device_dataset("cpu") is None
    assert tdp.Loader(trecs, TCFG, batch_size=4).device_dataset("cpu", max_bytes=1 << 30) \
        is not None
    monkeypatch.delenv("MMT_DEVICE_DATASET_GB")
    assert tdp.Loader(trecs, TCFG, batch_size=4).device_dataset("cpu") is not None


# ---------------------------------------------------------------------------
# the reference's shipped test sets
# ---------------------------------------------------------------------------

def _write_testset(tmp_path) -> dict:
    """Headerless ``SMILES,"[data]",sample-id`` CSVs in the reference's
    per-modality payload forms: a row that does not parse, an id missing
    from one modality, an id only one modality has, a short row."""
    rows = {
        "13C": [("CCO", "[58.2, 18.1]", "id_1"), ("CC(=O)O", "[177.0, 20.9]", "id_2"),
                ("c1ccccc1", "[128.4]", "id_3"), ("CCN", "[not a list", "id_4")],
        "HSQC": [("CCO", "[[3.69, 58.2], [1.22, 18.1]]", "id_1"),
                 ("c1ccccc1", "[[7.26, 128.4]]", "id_3"), ("CCN", "[[2.7, 36.7]]", "id_4")],
        "COSY": [("CCO", "[(3.69, 1.22), (1.22, 3.69)]", "id_1"), ("CC(=O)O", "[]", "id_2")],
        "1H": [("CCO", "[(3.69, 2.0), (1.22, 3.0)]", "id_1"), ("CCN", "[(2.7, 2.0)]", "id_4"),
               ("CCCl", "[(3.5, 2.0)]", "id_5"), ("CC",)],
    }
    paths = {}
    for key, table in rows.items():
        p = tmp_path / f"{key}.csv"
        with open(p, "w", newline="") as f:
            import csv

            csv.writer(f).writerows(table)
        paths[key] = str(p)
    return {"csv_13c": paths["13C"], "csv_hsqc": paths["HSQC"], "csv_cosy": paths["COSY"],
            "csv_1h": paths["1H"]}


@pytest.mark.parametrize("limit", [0, 2])
@pytest.mark.parametrize("modalities", ["all", "13c_hsqc"])
def test_load_reference_testset_matches_jax(tmp_path, limit, modalities):
    paths = _write_testset(tmp_path)
    if modalities != "all":
        paths = {k: paths[k] for k in ("csv_13c", "csv_hsqc")}
    ref = jdp.load_reference_testset(limit=limit, **paths)
    ours = tdp.load_reference_testset(limit=limit, **paths)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in ref]
    assert len(ours) == (limit or (5 if modalities == "all" else 4))


def test_ref_testset_split_matches_jax():
    ids = [f"ZINC{i:08d}" for i in range(200)] + ["", "id_1", "x" * 50]
    ours = [tdp.ref_testset_split(s) for s in ids]
    assert ours == [jdp.ref_testset_split(s) for s in ids]
    assert 60 < ours.count("adapt") < 140
