"""The corpus builders of the reference-test-set campaign against the JAX
scripts on the CPU: ``scripts/torch_zinc_corpus.py``,
``torch_make_r3_corpus.py``, ``torch_chemotype_stats.py``,
``torch_r4_mem_control.py``, ``torch_build_mixture_corpus.py`` and
``torch_build_sgnn_corpus.py``.

The inputs are a stand-in for the shipped test CSVs
(``chip_smoke.campaign_testset``), seeded corpora and record pickles the JAX
package wrote. Each JAX script runs from a copy under ``tmp_path/scripts/``,
its module-level ``REF``/``REF_DIR`` set to the stand-in (the JAX file is
not edited). Tolerances: the SMILES files and the printed statistics
byte-equal; the pickles' ids, order and counts equal, spectra exact where
copied and, where simulated, within 1e-5, but for at most 1% of the values
one rounding step (0.01 ppm) apart, where the two GNNs' float32 outputs
straddle the factory's rounding boundary."""

from __future__ import annotations

import os
import pickle
import random

import numpy as np
import pytest
import torch

import chip_smoke
from multimodalspectraltransformer_torch.data import molrandom
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_tpu.chem import api as jchem
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from torch_test_support import REPO, load, load_copy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ref"))
    chip_smoke.campaign_testset("cpu", d, n=20)
    return d


def _jax(name: str, tmp_path, ref_dir: str, attr: str = "REF"):
    """The JAX script ``scripts/<name>.py`` loaded from a copy, reading the
    stand-in."""
    mod = load_copy(f"scripts/{name}.py", str(tmp_path / "jax"))
    setattr(mod, attr, ref_dir)
    return mod


def _run_jax(mod, argv: list, monkeypatch) -> None:
    monkeypatch.setattr("sys.argv", [mod.__file__, *argv])
    rc = mod.main()
    assert rc in (None, 0)


def _fields(r) -> tuple:
    return (r.sample_id, r.smiles, r.h1, r.c13, r.hsqc, r.cosy,
            None if r.ir is None else np.asarray(r.ir).tolist())


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# zinc_corpus: fragmentation, assembly, the corpus file
# ---------------------------------------------------------------------------

SEEDS = [  # tests/test_zinc_corpus.py's ZINC-style molecules
    "Cc1ccc(C(=O)N2CCN(c3ncccn3)CC2)cc1F",
    "O=C(Nc1ccc(Cl)cc1)C1CCN(Cc2ccco2)CC1",
    "COc1ccc(CN(C)C(=O)c2cccnc2)cc1",
    "Cc1nnc(SCC(=O)Nc2ccccc2C)s1",
    "O=C(NCCc1ccccc1)c1cc2ccccc2o1",
    "c1ccccc1",
    "not a smiles",
]


def _frag_fields(f) -> tuple:
    return ([(a.symbol, a.aromatic, a.charge, a.explicit_h, a.isotope) for a in f.atoms],
            f.bonds, f.sites, f.n_heavy, f.has_ring)


@pytest.fixture(scope="module")
def zinc_scripts(tmp_path_factory):
    return (load("scripts/torch_zinc_corpus.py"),
            load_copy("scripts/zinc_corpus.py", str(tmp_path_factory.mktemp("jaxz"))))


@pytest.mark.parametrize("smiles", SEEDS)
def test_fragment_molecule_matches_jax(zinc_scripts, smiles):
    port, jax_script = zinc_scripts
    got = [_frag_fields(f) for f in port.fragment_molecule(smiles)]
    assert got == [_frag_fields(f) for f in jax_script.fragment_molecule(smiles)]
    if smiles in SEEDS[:5]:
        assert got and all(f[2] for f in got)


def test_assemble_matches_jax_under_one_seed(zinc_scripts):
    port, jax_script = zinc_scripts
    out = {}
    for side, mod in (("port", port), ("jax", jax_script)):
        frags = [f for s in SEEDS for f in mod.fragment_molecule(s)]
        ring = mod.Library([f for f in frags if f.has_ring])
        link = mod.Library([f for f in frags if not f.has_ring])
        rng = random.Random(3)
        out[side] = [mod.assemble(ring, link, rng) for _ in range(120)]
    assert out["port"] == out["jax"]
    assert sum(s is not None for s in out["port"]) >= 30


@pytest.mark.parametrize("case", ["default_mutate", "no_mutate_with_exclusions"])
def test_zinc_corpus_file_is_the_jax_scripts_byte_for_byte(tmp_path, ref_dir, monkeypatch, case):
    argv = ["--n", "60", "--seed", "41"]
    if case == "no_mutate_with_exclusions":
        excl = tmp_path / "prior.txt"
        excl.write_text("\n".join(molrandom.random_corpus(30, seed=8, min_mw=230, max_mw=390)) + "\n")
        argv = ["--n", "40", "--seed", "7", "--mutate", "0", "--mw-lo", "200", "--exclude",
                str(excl)]
    _run_jax(_jax("zinc_corpus", tmp_path, ref_dir), [*argv, "--out", str(tmp_path / "jax.txt")],
             monkeypatch)
    assert load("scripts/torch_zinc_corpus.py").main(
        [*argv, "--out", str(tmp_path / "port.txt"), "--ref-dir", ref_dir]) == 0
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    lines = got.decode().splitlines()
    assert len(lines) == len(set(lines)) and len(lines) >= 20
    # no shipped molecule of the eval half comes out
    chc, h1 = tdp.load_reference_sets(ref_dir)
    evals = {jchem.canonicalize(r.smiles) for r in chc + h1
             if tdp.ref_testset_split(r.sample_id) == "eval"}
    assert not evals & set(lines)


# ---------------------------------------------------------------------------
# make_r3_corpus and chemotype_stats
# ---------------------------------------------------------------------------

SMALL_SLABS = ((60, 21, 80.0, 550.0), (25, 31, 80.0, 250.0), (25, 32, 250.0, 350.0))


def test_make_r3_corpus_is_the_jax_scripts_byte_for_byte(tmp_path, monkeypatch):
    jax_script = load_copy("scripts/make_r3_corpus.py", str(tmp_path / "jax"))
    port = load("scripts/torch_make_r3_corpus.py")
    monkeypatch.setattr(jax_script, "SLABS", SMALL_SLABS)
    monkeypatch.setattr(port, "SLABS", SMALL_SLABS)
    _run_jax(jax_script, ["--out", str(tmp_path / "jax.txt")], monkeypatch)
    assert port.main(["--out", str(tmp_path / "port.txt")]) == 0
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    n = len(got.decode().splitlines())
    assert 60 < n <= 110 and not (tmp_path / "port.txt.tmp").exists()


@pytest.mark.parametrize("extra", [False, True])
def test_chemotype_stats_prints_the_jax_scripts_table(tmp_path, ref_dir, monkeypatch, capsys,
                                                     extra):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(molrandom.random_corpus(80, seed=21)) + "\n")
    argv = ["--corpus", str(corpus), "--sample", "50"]
    if extra:
        zinc = tmp_path / "zinc.txt"
        zinc.write_text("\n".join(molrandom.random_corpus(40, seed=9, min_mw=230)) + "\n")
        argv += ["--extra", str(zinc)]
    _run_jax(_jax("chemotype_stats", tmp_path, ref_dir), argv, monkeypatch)
    want = capsys.readouterr().out
    assert load("scripts/torch_chemotype_stats.py").main([*argv, "--ref-dir", ref_dir]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "ring_frac" in got and got.count("\n") > 16


# ---------------------------------------------------------------------------
# the three record pickles
# ---------------------------------------------------------------------------

def test_r4_mem_control_pickle_matches_jax(tmp_path, ref_dir, monkeypatch):
    argv = ["--dup", "3", "--key-seed", "4242"]
    _run_jax(_jax("r4_mem_control", tmp_path, ref_dir),
             [*argv, "--out", str(tmp_path / "jax" / "mem.pkl")], monkeypatch)
    assert load("scripts/torch_r4_mem_control.py").main(
        [*argv, "--out", str(tmp_path / "port" / "mem.pkl"), "--ref-dir", ref_dir]) == 0
    got, want = _read(str(tmp_path / "port" / "mem.pkl")), _read(str(tmp_path / "jax" / "mem.pkl"))
    assert (got["n"], got["seed"]) == (want["n"], want["seed"])
    assert [_fields(r) for r in got["records"]] == [_fields(r) for r in want["records"]]
    chc, _ = tdp.load_reference_sets(ref_dir)
    n_adapt = sum(tdp.ref_testset_split(r.sample_id) == "adapt" for r in chc)
    assert got["n"] == 3 * n_adapt and all(r.ir is None for r in got["records"])
    assert got["records"][n_adapt].sample_id.endswith("_m1")


def test_build_mixture_corpus_matches_jax(tmp_path, ref_dir, monkeypatch):
    """The zinclike cache (JAX-written records, IR included) and the
    memorization cache (the JAX script's) mixed by both scripts."""
    zc = tmp_path / "zc.pkl"
    with open(zc, "wb") as f:
        pickle.dump({"n": 12, "seed": 1, "records": jdp.synthetic_dataset(12, seed=3)}, f)
    mem = tmp_path / "mem.pkl"
    _run_jax(_jax("r4_mem_control", tmp_path, ref_dir), ["--dup", "2", "--out", str(mem)],
             monkeypatch)
    argv = ["--zc", str(zc), "--mem", str(mem), "--dup", "3", "--key-seed", "777"]
    _run_jax(load_copy("scripts/build_mixture_corpus.py", str(tmp_path / "jaxm")),
             [*argv, "--out", str(tmp_path / "jax.pkl")], monkeypatch)
    assert load("scripts/torch_build_mixture_corpus.py").main(
        [*argv, "--out", str(tmp_path / "port.pkl")]) == 0
    got, want = _read(str(tmp_path / "port.pkl")), _read(str(tmp_path / "jax.pkl"))
    assert (got["n"], got["seed"]) == (want["n"], want["seed"])
    assert [_fields(r) for r in got["records"]] == [_fields(r) for r in want["records"]]
    n_uniq = len({r.sample_id.split("_m")[0] for r in _read(str(mem))["records"]})
    assert got["n"] == 12 + 3 * n_uniq
    assert all(type(r) is tdp.SampleRecord for r in got["records"])


def test_build_sgnn_corpus_matches_jax(tmp_path, ref_dir, monkeypatch):
    """The SGNN corpus from a seeded corpus file (with two shipped molecules
    in it, to be excluded), the committed adapted weights, the stand-in and a
    JAX-written anchor cache: ids, order and counts equal; the real and
    anchor records exact; the simulated spectra within 1e-5."""
    chc, h1 = tdp.load_reference_sets(ref_dir)
    shipped = [jchem.canonicalize(chc[0].smiles), jchem.canonicalize(h1[1].smiles)]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(shipped + molrandom.random_corpus(40, seed=33)) + "\n")
    orig = tmp_path / "orig.pkl"
    anchors = jdp.synthetic_dataset(10, seed=4)
    anchors[2] = jdp.SampleRecord("o2", shipped[1], c13=[20.0])
    with open(orig, "wb") as f:
        pickle.dump({"n": 10, "seed": 2, "records": anchors}, f)
    weights = os.path.join(REPO, "multimodalspectraltransformer_tpu", "sim", "weights_sgnn")
    argv = ["--corpus", str(corpus), "--orig-cache", str(orig), "--weights", weights,
            "--n", "20", "--real-dup", "2", "--orig-frac", "0.3", "--chunk", "8",
            "--mw-lo", "100", "--mw-hi", "500"]
    _run_jax(_jax("build_sgnn_corpus", tmp_path, ref_dir, "REF_DIR"),
             [*argv, "--out", str(tmp_path / "jax.pkl")], monkeypatch)
    assert load("scripts/torch_build_sgnn_corpus.py").main(
        [*argv, "--out", str(tmp_path / "port.pkl"), "--ref-dir", ref_dir, "--device", "cpu"]) == 0
    got, want = _read(str(tmp_path / "port.pkl")), _read(str(tmp_path / "jax.pkl"))
    assert (got["n"], got["seed"]) == (want["n"], want["seed"])
    ids = [r.sample_id for r in got["records"]]
    assert ids == [r.sample_id for r in want["records"]]
    n_sim = sum(i.startswith("a") and i[1:].isdigit() for i in ids)
    n_real = sum(tdp.ref_testset_split(r.sample_id) == "adapt" for r in chc + h1)
    assert n_sim == 20 and got["n"] == 20 + 2 * n_real + 6  # int(20 * 0.3) anchors
    assert "o2" not in ids  # the shipped molecule among the anchors is left out
    assert not {r.smiles for r in got["records"][:n_sim]} & set(shipped)
    diffs = []
    for a, b in zip(want["records"], got["records"]):
        assert a.smiles == b.smiles and (a.ir is None) == (b.ir is None)
        if a.sample_id.startswith("a") and a.sample_id[1:].isdigit():
            assert b.ir is None
            for key in ("h1", "c13", "hsqc", "cosy"):
                x, y = getattr(a, key), getattr(b, key)
                assert (x is None) == (y is None), (a.sample_id, key)
                if x is not None:
                    assert np.shape(x) == np.shape(y), (a.sample_id, key)
                    diffs += np.abs(np.asarray(y, float) - np.asarray(x, float)).ravel().tolist()
        else:
            assert _fields(b) == _fields(a)
    # the factory rounds shifts to 0.01 ppm (1H lines to 1e-4): where the two
    # GNNs' float32 outputs straddle a rounding boundary, the peaks lie one
    # step apart. Every other value within 1e-5, and such steps rare.
    diffs = np.asarray(diffs)
    off = diffs > 1e-5
    assert diffs.size > 500 and (diffs[off] <= 0.01 + 1e-9).all() and off.sum() <= 0.01 * diffs.size
