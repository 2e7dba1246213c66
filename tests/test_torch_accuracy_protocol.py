"""The port's accuracy report (``scripts/torch_accuracy_report.py``) held to
the protocol of the JAX script (``scripts/accuracy_report.py``) on the CPU:
held-out generation and its validation, the reference test set's rows and
split, the records cache, chunk resume and ``--sim-weights``. The JAX
script itself runs beside the port in test_torch_accuracy_jax_script.py."""

from __future__ import annotations

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_tpu.chem import api as jax_chem
from multimodalspectraltransformer_tpu.data import molrandom as jax_molrandom
from multimodalspectraltransformer_tpu.data import pipeline as jax_dp
from multimodalspectraltransformer_tpu.models import mmt as jax_mmt
from multimodalspectraltransformer_tpu.train import checkpoint as jax_ckpt
from multimodalspectraltransformer_tpu.utils.config import ModelConfig as JaxModelConfig
from torch_test_support import PINNED, REPO, decoding_params, load

SIM_WEIGHTS = os.path.join(REPO, "multimodalspectraltransformer_tpu", "sim", "weights")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_params(tmp_path_factory):
    """ModelConfig.small() drawn by the JAX package from PRNGKey(0) and
    exported by it: both scripts load this file."""
    path = str(tmp_path_factory.mktemp("params") / "small.msgpack")
    jax_ckpt.export_params_msgpack(
        jax_mmt.init_params(JaxModelConfig.small(), jax.random.PRNGKey(0)), path)
    return path


def _jax_heldout(train_n, train_seed, extra, mw_band, n, heldout_seed) -> list:
    """The held-out list by the rules of ``accuracy_report.py:226-243``,
    through the JAX package's corpus generator."""
    train_set = set(jax_molrandom.random_corpus(train_n, seed=train_seed))
    for pair in filter(None, extra.split(",")):
        xseed, xn = (int(v) for v in pair.split(":"))
        train_set |= set(jax_molrandom.random_corpus(xn, seed=xseed))
    if mw_band:
        lo, hi = (float(x) for x in mw_band.split(","))
        pool = jax_molrandom.random_corpus(n * 2, seed=heldout_seed, min_mw=lo, max_mw=hi)
    else:
        pool = jax_molrandom.random_corpus(n * 2, seed=heldout_seed)
    return [s for s in pool if s not in train_set][:n]


@pytest.mark.parametrize("extra,mw_band", [("", ""), ("999:5,3:50", ""), ("999:3", "0,300")],
                         ids=["plain", "extra_exclude", "mw_band"])
def test_generated_heldout_list_is_the_jax_scripts(tmp_path, extra, mw_band):
    acc = load("scripts/torch_accuracy_report.py")
    argv = ["--train-n", "300", "--train-seed", "11", "--heldout-seed", "999", "--n", "12",
            "--out", str(tmp_path)]
    if extra:
        argv += ["--extra-exclude", extra]
    if mw_band:
        argv += ["--mw-band", mw_band]
    got = acc.heldout_smiles(acc.parse_args(argv))
    want = _jax_heldout(300, 11, extra, mw_band, 12, 999)
    assert got == want and len(got) == 12
    if extra and not mw_band:  # the held-out seed's own first 5 are excluded
        first = jax_molrandom.random_corpus(5, seed=999)
        assert not set(first) & set(got) and got[0] == want[0] != first[0]
    with open(tmp_path / "heldout_smiles.json") as f:
        saved = json.load(f)
    assert saved == {"train_n": 300, "train_seed": 11, "heldout_seed": 999, "n": 12,
                     "mw_band": mw_band, "extra_exclude": extra, "smiles": want}
    # a second run reads and validates it
    assert acc.heldout_smiles(acc.parse_args(argv)) == want


def test_heldout_key_mismatch_exits_and_a_legacy_list_is_taken(tmp_path, capsys):
    acc = load("scripts/torch_accuracy_report.py")
    key = {"train_n": 300, "train_seed": 11, "heldout_seed": 999, "n": 4, "mw_band": "",
           "extra_exclude": ""}
    with open(tmp_path / "heldout_smiles.json", "w") as f:
        json.dump({**key, "smiles": ["CCO"] * 4}, f)
    args = acc.parse_args(["--train-n", "301", "--train-seed", "11", "--n", "4",
                           "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="was built with different corpus flags: "
                                         r"\{'train_n': \(301, 300\)\}"):
        acc.heldout_smiles(args)
    with open(tmp_path / "heldout_smiles.json", "w") as f:
        json.dump(["CCO", "CCN", "CCC", "CCCl", "c1ccccc1"], f)
    assert acc.heldout_smiles(args) == ["CCO", "CCN", "CCC", "CCCl"]
    assert "legacy format, unvalidated" in capsys.readouterr().out


def _write_reference_csvs(d, smiles: list) -> None:
    """The four shipped test CSVs (headerless ``SMILES,"[data]",sample-id``)
    over ``smiles``, ids ``r<i>``; the 1H file misses the last row and holds a
    row whose data does not parse."""
    payload = {
        "ML_NMR_5M_XL_13C_test_10x100.csv": lambda i: str([20.5 + i, 130.25]),
        "ML_NMR_5M_XL_HSQC_test_10x100.csv": lambda i: str([[1.25, 20.5 + i]]),
        "ML_NMR_5M_XL_COSY_test_10x100.csv": lambda i: str([(1.25, 2.5 + 0.01 * i)]),
        "ML_NMR_1H_combined_ZINC_test_10x100.csv": lambda i: str([(1.25, 3.0), (7.25, 1.0)]),
    }
    for name, data in payload.items():
        with open(os.path.join(d, name), "w", newline="") as f:
            w = csv.writer(f)
            for i, s in enumerate(smiles):
                if name.startswith("ML_NMR_1H") and i == len(smiles) - 1:
                    w.writerow([s, "[(1.25, ", f"r{i}"])
                    continue
                w.writerow([s, data(i), f"r{i}"])


def _jax_reference_rows(d, mods, split, n, train_set) -> list:
    """The rows ``accuracy_report.py:148-191`` keeps, and the counts it prints."""
    recs = jax_dp.load_reference_testset(
        csv_13c=os.path.join(d, "ML_NMR_5M_XL_13C_test_10x100.csv") if "13c" in mods else "",
        csv_hsqc=os.path.join(d, "ML_NMR_5M_XL_HSQC_test_10x100.csv") if "hsqc" in mods else "",
        csv_cosy=os.path.join(d, "ML_NMR_5M_XL_COSY_test_10x100.csv") if "cosy" in mods else "",
        csv_1h=os.path.join(d, "ML_NMR_1H_combined_ZINC_test_10x100.csv") if "1h" in mods else "",
        limit=0 if split != "all" else n)
    if split != "all":
        recs = [r for r in recs if jax_dp.ref_testset_split(r.sample_id) == split]
        recs = recs[:n]
    kept, n_unparseable = [], 0
    for r in recs:
        can = jax_chem.canonicalize(r.smiles)
        if can is None:
            n_unparseable += 1
        elif can not in train_set:
            kept.append(r)
    line = (f"[acc] reference test set: {len(recs)} rows, {n_unparseable} unparseable SMILES "
            f"dropped, {len(recs) - n_unparseable - len(kept)} training-corpus overlaps dropped, "
            f"{len(kept)} evaluated (modalities: {sorted(mods)})")
    return [(r.sample_id, r.smiles, r.c13, r.hsqc, r.cosy, r.h1) for r in kept], line


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("refset")
    train = jax_molrandom.random_corpus(40, seed=11)
    smiles = jax_molrandom.random_corpus(14, seed=5) + [train[3], "C1CC", train[7]]
    _write_reference_csvs(d, smiles)
    return str(d), set(train)


@pytest.mark.parametrize("split,mods", [("all", "1h,13c,hsqc,cosy"), ("eval", "13c,hsqc"),
                                        ("adapt", "1h,13c,hsqc,cosy")])
def test_reference_testset_keeps_the_jax_scripts_rows(reference_dir, capsys, split, mods):
    d, train = reference_dir
    acc = load("scripts/torch_accuracy_report.py")
    n = 17 if split == "all" else 5  # all of them; the split's first 5
    args = acc.parse_args(["--ref-testset", d, "--ref-modalities", mods, "--ref-split", split,
                           "--n", str(n), "--train-n", "40", "--train-seed", "11"])
    got = [(r.sample_id, r.smiles, r.c13, r.hsqc, r.cosy, r.h1) for r in acc.reference_records(args)]
    want, line = _jax_reference_rows(d, set(mods.split(",")), split, n, train)
    assert got == want and want
    assert capsys.readouterr().out.strip() == line
    if split == "all":  # the unparseable row and both training molecules dropped
        assert line.startswith("[acc] reference test set: 17 rows, 1 unparseable SMILES dropped, "
                               "2 training-corpus overlaps dropped, 14 evaluated")


def test_reference_testset_report_on_cpu(reference_dir, small_params, tmp_path):
    d, _ = reference_dir
    acc = load("scripts/torch_accuracy_report.py")
    out = acc.run(acc.parse_args([
        "--device", "cpu", "--small", "--no-bf16", "--params", small_params, "--ref-testset", d,
        "--ref-split", "eval", "--n", "100", "--train-n", "40", "--fanout", "2",
        "--multinom-runs", "1", "--rounds", "1", "--max-len", "24", "--chunk-size", "16",
        "--out", str(tmp_path), "--report-dir", str(tmp_path), "--tag", "ref"]))
    report = out["report"]
    kept, _ = _jax_reference_rows(d, {"1h", "13c", "hsqc", "cosy"}, "eval", 100,
                                  set(jax_molrandom.random_corpus(40, seed=11)))
    assert [r.sample_id for r in out["records"]] == [k[0] for k in kept]
    assert report["n"] == len(kept) == len(out["records"])
    assert (report["ref_testset"], report["ref_split"], report["ref_modalities"]) == (
        d, "eval", "1h,13c,hsqc,cosy")
    assert report["heldout"] == "" and not (tmp_path / "heldout_smiles.json").exists()
    md = (tmp_path / "ACCURACY_ref.md").read_text()
    assert "**The reference's own shipped test set**" in md
    assert "| metric | value | reference (PubChem 250-350, V100) |" in md


@pytest.mark.parametrize("form", ["dir/", "bundle.tar.gz", "records.pkl.gz"])
def test_records_cache_round_trip(tmp_path, form):
    from multimodalspectraltransformer_torch.sim import factory

    acc = load("scripts/torch_accuracy_report.py")
    recs = factory.simulate_records(["CCO", "CC(=O)Nc1ccc(O)cc1", "c1ccccc1C"], device="cpu")
    path = str(tmp_path / form)
    assert not acc.cache_exists(path)
    acc.write_records(recs, path)
    assert acc.cache_exists(path)
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    back = acc.load_records(path, str(scratch))
    assert [(r.sample_id, r.smiles, r.h1, r.c13, r.hsqc, r.cosy) for r in back] == [
        (r.sample_id, r.smiles, r.h1, r.c13, r.hsqc, r.cosy) for r in recs]
    for a, b in zip(recs, back):
        np.testing.assert_array_equal(np.asarray(b.ir, np.float32), a.ir)


def test_legacy_chunk_counts_are_rebuilt_from_fractions():
    acc = load("scripts/torch_accuracy_report.py")
    legacy = {"top_k": {"1": 0.5, "3": 1.0},
              "molecules": [{"n_candidates": 3}, {"n_candidates": 0}, {"n_candidates": 1}]}
    assert acc.chunk_counts(legacy) == ({"1": 1, "3": 2}, 2)
    assert acc.chunk_counts({"top_k_hits": {"1": 4}, "top_k_n": 7}) == ({"1": 4}, 7)


def test_chunk_resume_records_cache_and_sim_weights(tmp_path, small_params, monkeypatch):
    """A first run simulates the records and writes the cache; a second run
    resumes every chunk; a chunk carrying the JAX script's digest is
    computed again; ``--sim-weights`` at the committed shift weights gives
    the report of the run without it."""
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.sim import distill

    acc = load("scripts/torch_accuracy_report.py")
    pinned = json.load(open(PINNED))[:4]
    cache = str(tmp_path / "cache") + "/"

    def argv(out, *extra):
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "heldout_smiles.json"), "w") as f:
            json.dump(pinned, f)
        return ["--device", "cpu", "--small", "--params", small_params, "--n", "4",
                "--chunk-size", "2", "--fanout", "2", "--multinom-runs", "1", "--rounds", "1",
                "--max-len", "24", "--records-cache", cache, "--out", out,
                "--report-dir", out, *extra]

    calls, sims = [], []
    real = harness.evaluate_molecules
    monkeypatch.setattr(harness, "evaluate_molecules", lambda *a, **k: calls.append(
        len(a[0])) or sims.append(k["sim_kwargs"]) or real(*a, **k))
    strip = lambda r: {k: v for k, v in r.items() if k not in ("wall_s_total",)}

    first = acc.run(acc.parse_args(argv(str(tmp_path / "a"))))
    assert calls == [2, 2] and os.path.exists(os.path.join(cache, "data_1H_0.csv"))
    assert [r.smiles for r in first["records"]] == pinned
    again = acc.run(acc.parse_args(argv(str(tmp_path / "a"))))
    assert calls == [2, 2], "a resumed run evaluated a chunk"
    assert strip(again["report"]) == strip(first["report"])

    # the JAX script's digest of chunk 0 (its decode key has no ".torch")
    params_hash, key = acc.run_key(acc.parse_args(argv(str(tmp_path / "a"))))
    chunk0 = tmp_path / "a" / "chunk_0000.json"
    payload = json.loads(chunk0.read_text())
    payload["digest"] = acc.chunk_digest(pinned[:2], params_hash, key.removesuffix(".torch"))
    payload["molecules"][0]["greedy_exact"] = "from the JAX script"
    chunk0.write_text(json.dumps(payload))
    acc.run(acc.parse_args(argv(str(tmp_path / "a"))))
    assert calls == [2, 2, 2]
    assert json.loads(chunk0.read_text())["digest"] == acc.chunk_digest(pinned[:2], params_hash, key)

    plain = acc.run(acc.parse_args(argv(str(tmp_path / "b"))))
    with pytest.raises(SystemExit, match="no weights found"):
        acc.run(acc.parse_args(argv(str(tmp_path / "c"), "--sim-weights", str(tmp_path / "none"))))
    alt = acc.run(acc.parse_args(argv(str(tmp_path / "d"), "--sim-weights", SIM_WEIGHTS)))
    assert calls == [2, 2, 2, 2, 2, 2, 2]
    assert sims[:5] == [None] * 5
    committed, _ = distill.load_shift_weights(SIM_WEIGHTS, "cpu")
    for sim in sims[5:]:  # the loaded model reached the harness
        assert sim["shift_model"] is not None
        assert _same_weights(sim["shift_model"], committed)
    assert alt["report"]["sim_weights"] == SIM_WEIGHTS
    own = ("sim_weights", "stage_seconds", "heldout")  # the option, the clock, the --out
    assert {k: v for k, v in strip(alt["report"]).items() if k not in own} \
        == {k: v for k, v in strip(plain["report"]).items() if k not in own}



def _same_weights(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_sim_weights_reach_the_candidate_errors(tmp_path, monkeypatch):
    """``--sim-weights`` at shift weights other than the committed ones: the
    harness gets that model, and the candidates' spectral errors move. The
    records are simulated with the committed weights and the small parameters
    are taught to decode each target, so the candidate pools hold their
    targets (where the MW gate lets them in), at error 0 under the committed
    weights and not under others."""
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.sim import distill, factory

    acc = load("scripts/torch_accuracy_report.py")
    pinned = json.load(open(PINNED))[1:4]
    records = factory.simulate_records(pinned, device="cpu")
    factory.export_reference_csvs(records, str(tmp_path / "records"))
    params = decoding_params(records, {s: s for s in pinned}, str(tmp_path / "small.msgpack"))
    model, stats = distill.load_shift_weights(SIM_WEIGHTS, "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.1)
    with open(os.path.join(SIM_WEIGHTS, "nmr_shift.json")) as f:
        meta = json.load(f)
    distill.save_shift_weights(model, meta["stats"], meta["report"], str(tmp_path / "shift"))

    seen = []
    real = harness.evaluate_molecules
    monkeypatch.setattr(harness, "evaluate_molecules", lambda *a, **k: seen.append(
        (k["sim_kwargs"], real(*a, **k))) or seen[-1][1])

    def errors(out, *extra):
        os.makedirs(out)
        with open(os.path.join(out, "heldout_smiles.json"), "w") as f:
            json.dump(pinned, f)
        acc.run(acc.parse_args([
            "--device", "cpu", "--small", "--no-bf16", "--params", params, "--n", "3",
            "--chunk-size", "3", "--fanout", "2", "--multinom-runs", "1", "--rounds", "1",
            "--max-len", "32", "--mix", "--records-cache", str(tmp_path / "records"),
            "--out", out, "--report-dir", out, *extra]))
        return [(c.smiles, c.hsqc_error, c.cosy_error) for r in seen[-1][1][0]
                for c in r.candidates if c.exact]

    plain = errors(str(tmp_path / "plain"))
    assert seen[-1][0] is None
    assert plain and all(h == 0.0 and c == 0.0 for _, h, c in plain)
    moved = errors(str(tmp_path / "moved"), "--sim-weights", str(tmp_path / "shift"))
    assert _same_weights(seen[-1][0]["shift_model"], model)
    assert [s for s, _, _ in moved] == [s for s, _, _ in plain]
    assert all(h > 0.0 for _, h, _ in moved)


def test_pinned_list_loader_serves_its_callers():
    """``load_heldout`` reads the 982 pinned molecules unvalidated, as
    ``chip_smoke.py``'s phase 8 and ``scripts/torch_heldout_precision.py``
    read them."""
    import chip_smoke

    acc = load("scripts/torch_accuracy_report.py")
    pinned = acc.load_heldout(os.path.dirname(PINNED), 982)
    assert pinned == json.load(open(PINNED)) and len(pinned) == 982
    with pytest.raises(SystemExit, match="fewer than 90%"):
        acc.load_heldout(os.path.dirname(PINNED), 2000)
    records = chip_smoke.pinned_heldout_records(4)
    assert len(records) == 4 and {r.smiles for r in records} <= set(pinned)
