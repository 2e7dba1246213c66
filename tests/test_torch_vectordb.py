"""The port's vector DB, ``cli vectorize``, UMAP and clustering tools
against the JAX package's ``eval/vectordb.py``, ``eval/umap.py`` and
``eval/clustering.py``.

Retrieval scores within 1e-6 of JAX's with the same indices, ties included;
the DB files read across packages; the CSV byte for byte; the model DB's
fingerprints at the small width within 1e-5; UMAP, PCA and t-SNE layouts
equal to JAX's (the same numpy and sklearn code on the same inputs)."""

from __future__ import annotations

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch import cli as tcli
from multimodalspectraltransformer_torch.eval import clustering as tclus
from multimodalspectraltransformer_torch.eval import umap as tumap
from multimodalspectraltransformer_torch.eval import vectordb as tvdb
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_tpu import cli as jcli
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.eval import clustering as jclus
from multimodalspectraltransformer_tpu.eval import umap as jumap
from multimodalspectraltransformer_tpu.eval import vectordb as jvdb
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMILES = [
    "CCO", "CCCO", "CCCCO",
    "c1ccccc1", "Cc1ccccc1", "CCc1ccccc1",
    "CC(=O)O", "CCC(=O)O",
    "C1CCCCC1",
]


def _float_db(kind: str):
    """A float32 DB with duplicate rows (tied scores) and a few exact
    repeats of a query."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((40, 32)).astype(np.float32)
    v[7] = v[3]
    v[20] = v[3]
    v[31] = v[12]
    return jvdb.VectorDB([f"m{i}" for i in range(len(v))], v, kind=kind)


def test_morgan_db_self_retrieval():
    db = tvdb.build_morgan_db(SMILES)
    assert len(db) == len(SMILES)
    scores, idx, names, valid = tvdb.query_smiles(db, ["CCO", "c1ccccc1"], k=3, device="cpu")
    assert valid.all()
    assert names[0][0] == "CCO" and abs(scores[0][0] - 1.0) < 1e-6
    assert names[1][0] == "c1ccccc1" and abs(scores[1][0] - 1.0) < 1e-6
    assert set(names[0][1:]) <= {"CCCO", "CCCCO", "CC(=O)O", "CCC(=O)O"}
    ref = jvdb.query_smiles(jvdb.build_morgan_db(SMILES), ["CCO", "c1ccccc1"], k=3)
    np.testing.assert_array_equal(idx, ref[1])
    assert names == ref[2]


# tanimoto is a metric of bit vectors: on signed floats its union nears 0
@pytest.mark.parametrize("kind,metric", [("morgan", m) for m in ("tanimoto", "cosine", "dot",
                                                                  "euclidean")]
                         + [("float", m) for m in ("cosine", "dot", "euclidean")])
def test_query_matches_jax_with_ties(kind, metric):
    if kind == "morgan":  # every molecule twice: each score ties with its twin
        jdb = jvdb.build_morgan_db(SMILES * 2)
        q = jdb.vectors[::3].astype(np.float32)
    else:
        jdb = _float_db("model")
        q = jdb.vectors[[3, 12, 0, 5]]
    tdb = tvdb.VectorDB(jdb.smiles, jdb.vectors, jdb.kind)
    k = len(jdb)  # every row, so every tie is ordered
    ref_s, ref_i, ref_n = jvdb.query(jdb, q, k=k, metric=metric)
    s, i, n = tvdb.query(tdb, q, k=k, metric=metric, device="cpu")
    assert i.dtype == ref_i.dtype and s.dtype == ref_s.dtype
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=1e-6, atol=1e-6 * np.abs(ref_s).max())
    assert n == ref_n


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_and_load_across_packages(tmp_path, writer):
    path = str(tmp_path / "db")
    dbs = {"jax": jvdb.build_morgan_db(SMILES), "torch": tvdb.build_morgan_db(SMILES)}
    dbs[writer].save(path)
    for loaded in (jvdb.VectorDB.load(path), tvdb.VectorDB.load(path)):
        assert loaded.smiles == SMILES and loaded.kind == "morgan"
        assert loaded.vectors.dtype == np.uint8
        np.testing.assert_array_equal(loaded.vectors, dbs["jax"].vectors)


@pytest.mark.parametrize("kind", ["morgan", "model"])
def test_export_csv_is_the_pandas_bytes(tmp_path, kind):
    if kind == "morgan":
        jdb = jvdb.build_morgan_db(SMILES)
    else:  # float32 values of every magnitude, a NaN, an infinity, a quoted name
        jdb = _float_db("model")
        jdb.vectors[0, :6] = [np.nan, np.inf, -np.inf, 1e-30, 1e20, 0.0]
        jdb.vectors[1] *= 1e-5
        jdb.smiles[2] = 'odd,"name"'
    tdb = tvdb.VectorDB(list(jdb.smiles), jdb.vectors, jdb.kind)
    jdb.export_csv(str(tmp_path / "j.csv"))
    tdb.export_csv(str(tmp_path / "t.csv"))
    with open(tmp_path / "j.csv", "rb") as a, open(tmp_path / "t.csv", "rb") as b:
        assert a.read() == b.read()


def test_build_model_db_matches_jax_at_small_width():
    cfg = ModelConfig.small()
    params = jmmt.init_params(cfg, jax.random.PRNGKey(2))
    records = jdp.synthetic_dataset(6, seed=4)
    ref = jvdb.build_model_db(records, params, cfg, batch_size=4)
    model = tmmt.MultimodalTransformer(cfg)
    model.load_state_dict(tconvert.from_jax_params(params))
    ours = tvdb.build_model_db(records, model, batch_size=4, device="cpu")
    assert ours.smiles == ref.smiles and ours.kind == "model"
    assert ours.vectors.dtype == np.float32 and ours.vectors.shape == ref.vectors.shape
    np.testing.assert_allclose(ours.vectors, ref.vectors, rtol=1e-5,
                               atol=1e-5 * np.abs(ref.vectors).max())


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines()


@pytest.mark.parametrize("query", ["CCO", "not(a smiles"])
def test_cli_vectorize_prints_the_jax_lines(tmp_path, query):
    smi = tmp_path / "mols.txt"
    smi.write_text("\n".join(SMILES) + "\n")
    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / name / "db")
        os.makedirs(os.path.dirname(out))
        rc, lines = _cli(main, ["vectorize", "--smiles", str(smi), "--out", out, "--csv",
                                "--query", query, "--k", "4"] + extra)
        outs[name] = (rc, [json.loads(x) for x in lines], out)
    (rc_j, lines_j, out_j), (rc_t, lines_t, out_t) = outs["jax"], outs["torch"]
    assert rc_t == rc_j == (0 if query == "CCO" else 1)
    assert lines_t[0] == {"n": len(SMILES), "out": out_t}
    assert lines_t[1:] == lines_j[1:]
    with open(out_j + ".csv", "rb") as a, open(out_t + ".csv", "rb") as b:
        assert a.read() == b.read()


def test_umap_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 0.3, (60, 32)), rng.normal(4, 0.3, (60, 32))])
    x[1] = x[0]  # a duplicate pair
    ours = tumap.umap_embed(x, n_epochs=100, random_state=1)
    np.testing.assert_allclose(ours, jumap.umap_embed(x, n_epochs=100, random_state=1),
                               rtol=1e-12, atol=1e-12)
    sep = np.linalg.norm(ours[:60].mean(0) - ours[60:].mean(0))
    assert sep > 2 * max(ours[:60].std(), ours[60:].std())


@pytest.mark.parametrize("method", ["pca", "umap", "tsne"])
def test_embed_matches_jax(method):
    v = jvdb.build_morgan_db(SMILES).vectors
    ours = tclus.embed(v, method=method)
    assert ours.shape == (len(SMILES), 2) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, jclus.embed(v, method=method), rtol=1e-6, atol=1e-6)


def test_labels_and_plot_exports_match_jax(tmp_path):
    v = jvdb.build_morgan_db(SMILES).vectors
    coords = tclus.pca(v)
    np.testing.assert_array_equal(coords, jclus.pca(v))
    labels = tclus.mw_labels(SMILES + ["not(valid"])
    assert labels == jclus.mw_labels(SMILES + ["not(valid"]) and labels[-1] == "invalid"
    assert tclus.formula_labels(["CCO", "c1ccccc1"]) == ["C2H6O", "C6H6"]
    assert tclus.formula_labels(SMILES) == jclus.formula_labels(SMILES)
    png = tclus.cluster_plot_png(coords, labels[:-1], str(tmp_path / "c.png"))
    assert os.path.getsize(png) > 1000
    for mod, name in ((tclus, "t.html"), (jclus, "j.html")):
        mod.cluster_plot_html(coords, SMILES, str(tmp_path / name), labels[:-1])
    text = (tmp_path / "t.html").read_text()
    assert "<svg" in text and "CCO" in text
    assert text == (tmp_path / "j.html").read_text()
    with pytest.raises(ValueError, match="no points"):
        tclus.cluster_plot_html(np.zeros((0, 2)), [], str(tmp_path / "e.html"))
