"""The JAX accuracy script (``scripts/accuracy_report.py``) run as it is,
beside the port's (``scripts/torch_accuracy_report.py``), on the CPU at a
small size: the same pinned molecules, records and small parameters
(``--small --no-bf16 --beam 2 --mix``, fan-out 4). The parameters decode real
molecules, some of them the target and some another one, so that the greedy
fields and the teacher-forced probability tell the two decoders apart."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_test_support import PINNED, RECORDS, REPO, decoding_params, load

TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pinned_params(tmp_path_factory):
    """The first four pinned molecules, their records from the committed
    bundle written as a records directory of their own, and small parameters
    taught to decode the second and fourth as themselves, the first as the
    third and the third as the fourth (the first is longer than
    ``--max-len``)."""
    from multimodalspectraltransformer_torch.sim import factory

    pinned = json.load(open(PINNED))[:4]
    tmp = tmp_path_factory.mktemp("params")
    records = [r for r in load("scripts/torch_accuracy_report.py").load_records(
        RECORDS, str(tmp / "bundle")) if r.smiles in pinned]
    factory.export_reference_csvs(records, str(tmp / "records"))
    taught = dict(zip(pinned, [pinned[2], pinned[1], pinned[3], pinned[3]]))
    return pinned, str(tmp / "records"), decoding_params(records, taught,
                                                         str(tmp / "small.msgpack"))


def test_report_matches_the_jax_script_on_the_cpu(tmp_path, pinned_params):
    """The JAX script as it is (copied so that its ACCURACY_* files land in
    tmp_path) and the port on the same pinned molecules, records and small
    parameters: greedy fields per molecule, the teacher-forced probability
    within 1e-5 and, where float32 holds it, within a relative 1e-4, the band
    counts, and every JAX report key in the port's."""
    pinned, records, params = pinned_params
    (tmp_path / "scripts").mkdir()
    shutil.copy(os.path.join(REPO, "scripts", "accuracy_report.py"), tmp_path / "scripts")
    outs = {}
    for side in ("jax", "port"):
        outs[side] = tmp_path / side
        outs[side].mkdir()
        with open(outs[side] / "heldout_smiles.json", "w") as f:
            json.dump(pinned, f)
    common = ["--params", params, "--n", "4", "--chunk-size", "4", "--fanout", "4",
              "--multinom-runs", "2", "--rounds", "2", "--max-len", "32", "--no-bf16",
              "--beam", "2", "--mix", "--small", "--records-cache", records]
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "TMPDIR": str(tmp_path),
           "MMT_XLA_CACHE": str(tmp_path / "xla")}
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "scripts" / "accuracy_report.py"), *common, "--cpu",
         "--out", str(outs["jax"]), "--tag", "jax"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    load("scripts/torch_accuracy_report.py").main(
        [*common, "--device", "cpu", "--out", str(outs["port"]), "--tag", "port",
         "--report-dir", str(tmp_path)])
    jax_report = json.load(open(tmp_path / "ACCURACY_jax.json"))
    port_report = json.load(open(tmp_path / "ACCURACY_port.json"))
    assert set(jax_report) <= set(port_report)
    assert (port_report["beam_candidates"], port_report["greedy_in_pool"]) == (2, True)
    jax_mols = json.load(open(outs["jax"] / "chunk_0000.json"))["molecules"]
    port_mols = json.load(open(outs["port"] / "chunk_0000.json"))["molecules"]
    assert [m["target"] for m in port_mols] == [m["target"] for m in jax_mols]
    for j, p in zip(jax_mols, port_mols):
        assert p["greedy_exact"] == j["greedy_exact"]
        assert p["greedy_tanimoto"] == pytest.approx(j["greedy_tanimoto"], abs=1e-12)
        assert abs(p["corr_sampling_prob"] - j["corr_sampling_prob"]) <= 1e-5
        if j["corr_sampling_prob"] >= TINY:
            assert p["corr_sampling_prob"] == pytest.approx(j["corr_sampling_prob"], rel=1e-4)
        else:  # the JAX package flushes float32's subnormals to 0
            assert p["corr_sampling_prob"] < TINY
    # what makes the comparison bite: exact and wrong but valid decodes, and
    # probabilities far from 0
    assert {m["greedy_exact"] for m in jax_mols} == {True, False}
    assert any(0.0 < m["greedy_tanimoto"] < 1.0 for m in jax_mols)
    assert sum(m["corr_sampling_prob"] > 0.1 for m in jax_mols) >= 2
    assert {k: b["n"] for k, b in port_report["mw_bands"].items()} == {
        k: b["n"] for k, b in jax_report["mw_bands"].items()}
    assert port_report["n"] == jax_report["n"] == 4
    assert not (tmp_path / "ACCURACY.md").exists()
