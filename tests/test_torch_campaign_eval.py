"""The simulator-matched control (``scripts/torch_control_adapted_sim_eval.py``)
against the JAX script (``scripts/control_adapted_sim_eval.py``) on the CPU,
and the real-data demo's whole run (``scripts/torch_real_data_demo.py``; its
parts against the JAX script's are in ``test_torch_campaign_demo.py``).

The control runs both mains on a stand-in for the shipped test CSVs
(``chip_smoke.campaign_testset``) with ``--sim-weights`` at the committed
shift weights scaled by 1.1, and ``evaluate_molecules`` replaced in both
packages by a spy that returns the same injected results: the simulated
records within 1e-5 (but for at most 1% of the values one rounding step
apart, as in ``test_torch_campaign_corpus.py``), the model of
``--sim-weights`` in the harness's ``sim_kwargs``, the summaries equal."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from multimodalspectraltransformer_torch.eval import harness as tharness
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.sim import distill as tdistill
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.train import checkpoint
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.eval import harness as jharness
from multimodalspectraltransformer_tpu.utils import cache as jcache
from torch_test_support import REPO, injected_evaluate, load, load_copy

PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")

AZ_SMILES = ["CCOC(=O)c1ccccc1", "CC(C)Cc1ccc(C(C)C(=O)O)cc1", "O=C(O)c1ccccc1O",
             "CCN(CC)CC(=O)Nc1c(C)cccc1C", "COc1ccc(CC(C)N)cc1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the simulator-matched control
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def control_inputs(tmp_path_factory):
    """The stand-in's directory and shift weights scaled by 1.1."""
    d = tmp_path_factory.mktemp("control")
    chip_smoke.campaign_testset("cpu", str(d / "ref"), n=20)
    moved, stats = tdistill.load_shift_weights(tdistill.WEIGHTS_DIR, "cpu")
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1.1)
    with open(os.path.join(tdistill.WEIGHTS_DIR, "nmr_shift.json")) as f:
        meta = json.load(f)
    tdistill.save_shift_weights(moved, meta["stats"], meta["report"], str(d / "moved"))
    return str(d / "ref"), str(d / "moved")


def _assert_spectra_close(got: list, want: list) -> None:
    """Simulated records: the same ids and fields; values within 1e-5, but
    for at most 1% one rounding step (0.01 ppm) apart."""
    assert [r.sample_id for r in got] == [r.sample_id for r in want]
    diffs = []
    for a, b in zip(want, got):
        assert a.smiles == b.smiles and a.ir is None and b.ir is None
        for key in ("h1", "c13", "hsqc", "cosy"):
            x, y = getattr(a, key), getattr(b, key)
            assert (x is None) == (y is None), (a.sample_id, key)
            if x is not None:
                assert np.shape(x) == np.shape(y), (a.sample_id, key)
                diffs += np.abs(np.asarray(y, float) - np.asarray(x, float)).ravel().tolist()
    diffs = np.asarray(diffs)
    off = diffs > 1e-5
    assert diffs.size > 100 and (diffs[off] <= 0.01 + 1e-9).all() and off.sum() <= 0.01 * diffs.size


@pytest.mark.parametrize("keep_1h", [False, True])
def test_control_eval_matches_the_jax_script(tmp_path, control_inputs, monkeypatch, keep_1h):
    ref_dir, moved = control_inputs
    argv = ["--params", PHASE3, "--n", "9", "--chunk-size", "4", "--sim-weights", moved,
            *(["--keep-1h"] if keep_1h else [])]
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jharness, "evaluate_molecules", injected_evaluate(jharness, seen["jax"]))
    monkeypatch.setattr(tharness, "evaluate_molecules", injected_evaluate(tharness, seen["port"]))
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: "")
    jax_script = load_copy("scripts/control_adapted_sim_eval.py", str(tmp_path / "jax"))
    jax_script.REF = ref_dir
    monkeypatch.setattr("sys.argv", ["control_adapted_sim_eval.py", *argv, "--out",
                                     str(tmp_path / "jax.json")])
    assert jax_script.main() == 0
    assert load("scripts/torch_control_adapted_sim_eval.py").main(
        [*argv, "--out", str(tmp_path / "port.json"), "--ref-dir", ref_dir,
         "--device", "cpu"]) == 0
    # the chunks: 4 + 4 + 1 of the adapt half, each simulated by --sim-weights
    assert [len(recs) for recs, _ in seen["port"]] == [len(recs) for recs, _ in seen["jax"]] \
        == [4, 4, 1]
    _assert_spectra_close([r for recs, _ in seen["port"] for r in recs],
                          [r for recs, _ in seen["jax"] for r in recs])
    assert all((r.h1 is not None) == keep_1h for recs, _ in seen["port"] for r in recs)
    want_model, want_stats = tdistill.load_shift_weights(moved, "cpu")
    committed, _ = tdistill.load_shift_weights(tdistill.WEIGHTS_DIR, "cpu")
    for _, sim_kwargs in seen["port"]:
        assert set(sim_kwargs) == {"shift_model", "stats"} and sim_kwargs["stats"] == want_stats
        assert chip_smoke._same_weights(sim_kwargs["shift_model"], want_model)
        assert not chip_smoke._same_weights(sim_kwargs["shift_model"], committed)
    got, want = (json.load(open(tmp_path / f"{s}.json")) for s in ("port", "jax"))
    assert got.pop("script") == "scripts/torch_control_adapted_sim_eval.py"
    want.pop("script")
    assert got == want and got["n"] == 9


# ---------------------------------------------------------------------------
# the real-data demo's whole run (its parts: test_torch_campaign_demo.py)
# ---------------------------------------------------------------------------

def test_real_data_demo_writes_the_jax_scripts_files_under_out(tmp_path):
    """The whole demo at ``ModelConfig.small()`` on the CPU (1 and 2 steps,
    fan-out 4, 1 round): REAL_DATA_DEMO.json with the keys of the committed
    JAX run's, the markdown with its per-molecule table's five separators,
    both in ``--out`` and none at the repository's root touched."""
    d = str(tmp_path / "az")
    recs = tfactory.simulate_records(AZ_SMILES, sample_ids=[f"AZ{i}" for i in range(5)],
                                     device="cpu")
    chip_smoke.write_az_example(d, recs)
    params = tmp_path / "small.msgpack"
    checkpoint.export_params_msgpack(tmmt.init_model(tconfig.ModelConfig.small(dropout=0.0), 3,
                                                     "cpu"), str(params))
    root = {n: os.path.getmtime(os.path.join(REPO, n)) for n in ("REAL_DATA_DEMO.json",
                                                                 "REAL_DATA_DEMO.md")}
    port = load("scripts/torch_real_data_demo.py")
    args = port.parse_args(["--params", str(params), "--dir", d, "--steps", "1", "--steps2", "2",
                            "--fanout", "4", "--rounds", "1", "--out", str(tmp_path / "out"),
                            "--device", "cpu"])
    out = port.run(args, tconfig.ModelConfig.small(dropout=0.0))
    written = json.load(open(tmp_path / "out" / "REAL_DATA_DEMO.json"))
    assert written == json.loads(json.dumps(out))
    committed = json.load(open(os.path.join(REPO, "REAL_DATA_DEMO.json")))

    def same_keys(a, b) -> bool:
        """The same dict keys at every level; list items compared where both
        lists have some."""
        if isinstance(a, dict) or isinstance(b, dict):
            return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                    and all(same_keys(a[k], b[k]) for k in a))
        if isinstance(a, list) and isinstance(b, list):
            return not (a and b) or same_keys(a[0], b[0])
        return True

    assert same_keys(written, committed)
    for arm in ("zero_shot", "real_data_blend", "real_data_decoder"):
        assert len(written[arm]["molecules"]) == 5
    md = (tmp_path / "out" / "REAL_DATA_DEMO.md").read_text()
    assert "| molecule | zs best tan | blend LOO | decoder LOO | zs top-rank tan |\n|---|---|---|---|---|\n" in md
    assert md.count("\n| `") == 5
    assert {n: os.path.getmtime(os.path.join(REPO, n)) for n in root} == root
