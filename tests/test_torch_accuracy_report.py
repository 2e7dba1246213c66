"""The port's held-out accuracy report (``scripts/torch_accuracy_report.py``)
end to end on the CPU, at a tiny size: the pinned held-out list and records,
phase3 and clip_r4, a few molecules in chunks of two."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from torch_test_support import REPO, load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_report_runs_on_cpu_with_the_jax_reports_keys(tmp_path):
    shutil.copy(os.path.join(REPO, "runs", "accuracy_r3", "heldout_smiles.json"), tmp_path)
    rc = load("scripts/torch_accuracy_report.py").main([
        "--device", "cpu", "--n", "3", "--chunk-size", "2", "--fanout", "8", "--multinom-runs", "3",
        "--rounds", "2", "--out", str(tmp_path), "--report-dir", str(tmp_path), "--tag", "t",
        "--params", os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz"),
        "--records-cache", os.path.join(REPO, "runs", "accuracy_r2b", "heldout_csv.tar.gz"),
        "--clip-params", os.path.join(REPO, "weights", "clip_r4.msgpack.gz")])
    assert rc == 0
    report = json.load(open(tmp_path / "ACCURACY_t.json"))
    with open(os.path.join(REPO, "ACCURACY_r05clip.json")) as f:
        reference = json.load(f)
    for key in ("n", "greedy_exact", "greedy_tanimoto", "mns_exact", "best_tanimoto",
                "corr_sampling_prob", "top_k_by_error", "top_k_n", "top_k_by_error_plus_clip",
                "top_k_by_clip_only", "clip_params", "mw_bands", "wall_s_total", "params", "fanout",
                "multinom_runs", "beam_candidates", "greedy_in_pool"):
        assert key in report and key in reference, key
    assert report["n"] == 3 and report["device"] == "cpu"
    assert set(report["top_k_by_error_plus_clip"]) == set(reference["top_k_by_error_plus_clip"])
    assert 0 <= report["greedy_bf16_differs_from_f32"] <= 3
    assert "clip" in report["stage_seconds"]
    assert 0 <= report["target_zero_error"] <= report["target_in_pool"] <= 3
    assert len(json.load(open(tmp_path / "molecules.json"))) == 3
    md = (tmp_path / "ACCURACY_t.md").read_text()
    assert "CLIP re-ranking" in md and "greedy exact recovery" in md
    assert not [p for p in os.listdir(tmp_path) if p.startswith("tmp")]  # unpacked records removed
