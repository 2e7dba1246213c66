"""The SGNN adaptation of the shift GNN (``scripts/torch_sgnn_adapt.py``)
against the JAX script (``scripts/sgnn_adapt.py``) on the CPU.

Inputs: a stand-in for the reference's shipped test CSVs, written by
``chip_smoke.campaign_testset`` (random molecules of 250-350 Da simulated by
the committed shift weights scaled by 1.1, ids in both halves of the split),
and numpy-seeded peak lists. The JAX script runs from a copy under
``tmp_path/scripts/``, so every default path it derives points there.
Tolerances: the alignment DP, the multiplet clustering and the assignment
dataset exact; the GNN's predictions and the peak-level metrics 1e-5; the
fine-tune's report 1e-5 (its metrics after the fine-tune as
``test_main_matches_the_jax_script`` says) and its weights 1e-5 of each
leaf's largest magnitude (the distillation trainer's bound)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert
from multimodalspectraltransformer_torch.sim import distill as tdistill
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.sim import factory as jfactory
from torch_test_support import load, load_copy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """(the port's script, the JAX script loaded from a copy)."""
    return (load("scripts/torch_sgnn_adapt.py"),
            load_copy("scripts/sgnn_adapt.py", str(tmp_path_factory.mktemp("jax"))))


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ref"))
    chip_smoke.campaign_testset("cpu", d, n=20)
    return d


@pytest.fixture(scope="module")
def halves(ref_dir):
    """The stand-in's records as each package loads them, split."""
    out = {}
    for side, mod in (("port", tdp), ("jax", jdp)):
        chc, h1 = tdp.load_reference_sets(ref_dir) if side == "port" else (
            jdp.load_reference_testset(**{f"csv_{m}": os.path.join(ref_dir, tdp.REF_TESTSET_FILES[m])
                                          for m in ("13c", "hsqc", "cosy")}),
            jdp.load_reference_testset(csv_1h=os.path.join(ref_dir, tdp.REF_TESTSET_FILES["1h"])))
        out[side] = {f"{name}_{half}": [r for r in recs if mod.ref_testset_split(r.sample_id) == half]
                     for name, recs in (("chc", chc), ("h1", h1)) for half in ("adapt", "eval")}
    return out


@pytest.fixture(scope="module")
def models():
    """(the port's committed shift model and stats on the CPU, JAX's (params,
    model, stats))."""
    return tfactory.default_shift_model("cpu"), jfactory.default_shift_model()


_RNG = np.random.default_rng(14)
ALIGN_CASES = {
    # the cases of tests/test_sgnn_adapt.py, with their answers
    "consolidation_many_to_one": ([10.0, 11.0, 30.0, 50.0], [10.5, 29.0, 51.0], np.inf, [0, 0, 1, 2]),
    "equal_counts_identity": ([1.0, 2.0, 3.0], [1.1, 2.1, 3.1], np.inf, [0, 1, 2]),
    "skip_spurious_peak": ([10.0, 50.0], [10.2, 30.0, 50.1], 0.6, [0, 2]),
    "infeasible_without_skip": ([10.0], [10.0, 20.0], np.inf, [None]),
    "crossing_resolved_monotonically": ([5.0, 6.0], [5.4, 5.6], np.inf, [0, 1]),
    # numpy-seeded: 13C-like many-to-one and 1H-like with skips
    "random_c13": (np.sort(_RNG.uniform(10, 180, 14)), np.sort(_RNG.uniform(10, 180, 9)), np.inf,
                   None),
    "random_h1_skips": (np.sort(_RNG.uniform(0.5, 8, 6)), np.sort(_RNG.uniform(0.5, 8, 9)), 0.6,
                        None),
    "empty_peaks": ([1.0, 2.0], [], np.inf, [None, None]),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_monotone_align_matches_jax(scripts, case):
    port, jax_script = scripts
    pred, peaks, pen, want = ALIGN_CASES[case]
    pred, peaks = np.asarray(pred, float), np.asarray(peaks, float)
    got = port.monotone_align(pred, peaks, skip_pen=pen)
    assert got == jax_script.monotone_align(pred, peaks, skip_pen=pen)
    if want is not None:
        assert got == want
    else:
        assert None not in got and got == sorted(got)


def _random_h1(seed: int) -> list:
    """Multiplets of 1-4 lines 0.0175 ppm apart around seeded centres."""
    rng = np.random.default_rng(seed)
    peaks = []
    for c in rng.uniform(0.5, 9.0, 7):
        k = int(rng.integers(1, 5))
        peaks += [[float(c + 0.0175 * j), float(rng.uniform(0.2, 2.0))] for j in range(k)]
    return peaks


CLUSTER_CASES = {
    "triplet_plus_singlet": [(1.00, 0.5), (1.0175, 1.0), (1.035, 0.5), (3.5, 2.0)],
    "overlapping_multiplets_merge": [(1.259, 1.5), (1.263, 1.5), (1.274, 1.5), (1.279, 1.5)],
    "random_a": _random_h1(1),
    "random_b": _random_h1(2),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster_multiplets_matches_jax(scripts, case):
    port, jax_script = scripts
    peaks = CLUSTER_CASES[case]
    got = port.cluster_multiplets(peaks)
    assert got == jax_script.cluster_multiplets(peaks)
    if case == "triplet_plus_singlet":
        assert len(got) == 2 and abs(got[0][0] - 1.0175) < 1e-9 and got[1] == (3.5, 2.0, 1)
    if case == "overlapping_multiplets_merge":
        assert len(got) == 1


def _end_to_end_records(mod):
    """tests/test_sgnn_adapt.py's records: a consolidated 13C list with HSQC
    pairs, and a 1H list of two multiplets."""
    smi = "CCOC(=O)c1ccccc1"
    sim = tfactory.simulate_records([smi], sample_ids=["t0"], device="cpu")[0]
    chc = [mod.SampleRecord("t0", smi, c13=sim.c13, hsqc=sim.hsqc)]
    h1 = [mod.SampleRecord("t1", "CCO", h1=[[1.1, 0.5], [1.117, 1.0], [1.135, 0.5],
                                            [3.6, 0.5], [3.617, 1.0], [3.635, 0.5]])]
    return chc, h1


@pytest.mark.parametrize("inputs", ["end_to_end_labels", "stand_in_adapt_halves"])
def test_build_assignment_dataset_matches_jax(scripts, models, halves, inputs):
    port, jax_script = scripts
    (tmodel, tstats), (jparams, jmodel, jstats) = models
    if inputs == "end_to_end_labels":
        tin, jin = _end_to_end_records(tdp), _end_to_end_records(jdp)
    else:
        tin = (halves["port"]["chc_adapt"], halves["port"]["h1_adapt"])
        jin = (halves["jax"]["chc_adapt"], halves["jax"]["h1_adapt"])
    data, info = port.build_assignment_dataset(*tin, tmodel, tstats, device="cpu")
    ref, ref_info = jax_script.build_assignment_dataset(*jin, jparams, jmodel, jstats)
    assert info == ref_info
    assert info["c_labels"] > 0 and info["h_hsqc_labels"] + info["h_clust_labels"] > 0
    assert set(data) == set(ref)
    for k, v in ref.items():
        assert data[k].dtype == v.dtype, k
        np.testing.assert_array_equal(data[k], v, err_msg=k)
    assert data["mask_c"].sum() == info["c_labels"]
    assert data["mask_h"].sum() == info["h_hsqc_labels"] + info["h_clust_labels"]


def test_predict_all_matches_jax(scripts, models, halves):
    port, jax_script = scripts
    (tmodel, tstats), (jparams, jmodel, jstats) = models
    recs = halves["port"]["chc_eval"] + halves["port"]["h1_eval"]
    got = port.predict_all(recs, tmodel, tstats, "cpu")
    ref = jax_script.predict_all(halves["jax"]["chc_eval"] + halves["jax"]["h1_eval"], jparams,
                                 jmodel, jstats)
    assert [g[0].sample_id for g in got] == [r[0].sample_id for r in ref] \
        == [r.sample_id for r in recs]
    for (_, _, sc, sh), (_, _, rc, rh) in zip(got, ref):
        np.testing.assert_allclose(sc, rc, rtol=0, atol=1e-5 * max(1.0, float(np.abs(rc).max())))
        np.testing.assert_allclose(sh, rh, rtol=0, atol=1e-5 * max(1.0, float(np.abs(rh).max())))


@pytest.mark.parametrize("half", ["chc_eval", "h1_eval"])
def test_eval_metrics_match_jax(scripts, models, halves, half):
    port, jax_script = scripts
    (tmodel, tstats), (jparams, jmodel, jstats) = models
    got = port.eval_metrics(halves["port"][half], tmodel, tstats, "cpu")
    ref = jax_script.eval_metrics(halves["jax"][half], jparams, jmodel, jstats)
    assert set(got) == set(ref) and got
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k


def _assert_close_tree(got, ref, what=""):
    """Nested dicts of numbers: equal keys, numbers within 1e-5 relative."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _assert_close_tree(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, (int, float)) and not isinstance(ref, bool):
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-6), what
    else:
        assert got == ref, what


def test_main_matches_the_jax_script(scripts, ref_dir, tmp_path, monkeypatch):
    """Both mains at 5 steps of batch 16: the split, the report (the
    assignment counts exact, the metrics before the fine-tune, the trainer's
    MAEs and loss within 1e-5) and the adapted weights within 1e-5 of each
    leaf's largest magnitude. The metrics after it go through the
    reconstruction, which rounds shifts to 0.01 ppm (1e-4 in 1H), so weights
    1e-5 apart may put a peak one step over: they are held within 1e-5 where
    the port's ``eval_metrics`` reads JAX's adapted weights, and within 1e-3
    relative (a step on one peak of the HSQC mean) from the port's own."""
    port, jax_script = scripts
    common = ["--ref-dir", ref_dir, "--steps", "5", "--batch-size", "16", "--lr", "3e-4"]
    out = {side: (str(tmp_path / side / "weights"), str(tmp_path / side / "report"))
           for side in ("port", "jax")}
    monkeypatch.setattr("sys.argv", ["sgnn_adapt.py", *common, "--out", out["jax"][0],
                                     "--report", out["jax"][1]])
    jax_script.main()
    assert port.main([*common, "--out", out["port"][0], "--report", out["port"][1],
                      "--device", "cpu"]) == 0
    read = {side: json.load(open(os.path.join(out[side][1], "report.json"))) for side in out}
    after = {side: read[side].pop("eval_after") for side in out}
    for side in out:
        read[side].pop("provenance")
    _assert_close_tree(read["port"], read["jax"])
    jax_weights = tdistill.load_shift_weights(out["jax"][0], "cpu")
    chc, h1 = tdp.load_reference_sets(ref_dir)
    _assert_close_tree({"chc_eval": port.eval_metrics([r for r in chc if tdp.ref_testset_split(
        r.sample_id) == "eval"], *jax_weights, "cpu"), "h1_eval": port.eval_metrics(
            [r for r in h1 if tdp.ref_testset_split(r.sample_id) == "eval"], *jax_weights, "cpu")},
        after["jax"])
    for half, metrics in after["jax"].items():
        for k, v in metrics.items():
            assert after["port"][half][k] == pytest.approx(v, rel=1e-3), (half, k)
    assert read["port"]["assignment"]["mols"] > 0
    assert (after["port"]["chc_eval"]["c13_nn_mae_ppm"]
            < read["port"]["eval_before"]["chc_eval"]["c13_nn_mae_ppm"])
    split = {side: json.load(open(os.path.join(out[side][1], "split.json"))) for side in out}
    assert split["port"] == split["jax"]
    meta = {side: json.load(open(os.path.join(out[side][0], "nmr_shift.json"))) for side in out}
    assert meta["port"]["stats"] == meta["jax"]["stats"]
    got = convert.linear_params(convert.read_msgpack(os.path.join(out["port"][0], "nmr_shift.msgpack")))
    ref = convert.linear_params(convert.read_msgpack(os.path.join(out["jax"][0], "nmr_shift.msgpack")))
    assert got.keys() == ref.keys()
    for k in ref:
        err = float((got[k] - ref[k]).abs().max())
        assert err <= 1e-5 * float(ref[k].abs().max()), (k, err)
