"""The port's ``cli simulate``, ``evaluate``, ``improve`` and ``serve`` on
the CPU, and the reference CSV export behind ``simulate``.

Each command prints the keys the JAX package's command of the same name
prints (taken from the JAX command itself, its heavy work stubbed out); the
port's evaluate summary adds ``stage_seconds``. The CSV export is byte for
byte the JAX package's pandas writer on the same records."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch import cli as tcli
from multimodalspectraltransformer_torch import serve as tserve
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.train import checkpoint as tckpt
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu import cli as jcli
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.eval import harness as jh
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.sim import factory as jfactory
from multimodalspectraltransformer_tpu.train import checkpoint as jckpt
from multimodalspectraltransformer_tpu.train import improvement_cycle as jic
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv) -> list:
    """Run a CLI; return its exit code and its last stdout line as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _smiles_file(tmp_path, smiles, name="mols.txt"):
    path = tmp_path / name
    path.write_text("\n".join(smiles) + "\n")
    return str(path)


def test_read_smiles_matches_jax(tmp_path):
    """A CSV with a SMILES column, a CSV without (its first column), a text
    file with blank lines."""
    files = {
        "with.csv": "id,SMILES,x\n1,CCO,a\n2,\"CC(=O)O\",b\n",
        "without.csv": "smi,y\nc1ccccc1,3\nCCN,4\n",
        "plain.txt": "CCO\n\n  CCN \nc1ccccc1\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
        path = str(tmp_path / name)
        assert tcli._read_smiles(path) == jcli._read_smiles(path), name


def test_export_reference_csvs_byte_equal_to_jax(tmp_path):
    """Records the port simulated, one without 13C, one with a float64 IR
    holding a NaN, one without IR: every file the same bytes."""
    recs = tfactory.simulate_records(["CC(=O)Nc1ccc(O)cc1", "CCOC(=O)c1ccccc1", "OCC(Cl)c1ccncc1"],
                                     device="cpu")
    recs[1].c13 = None
    recs[2].ir = np.asarray(recs[2].ir, np.float64)
    recs[2].ir[3] = np.nan
    recs.append(dataclasses.replace(recs[0], sample_id="no-ir", ir=None))
    ours = tfactory.export_reference_csvs(recs, str(tmp_path / "port"), run_id="7")
    ref = jfactory.export_reference_csvs(recs, str(tmp_path / "jax"), run_id="7")
    assert {k: os.path.relpath(v, tmp_path / "port") for k, v in ours.items()} == \
        {k: os.path.relpath(v, tmp_path / "jax") for k, v in ref.items()}
    names = []
    for root, _dirs, files in os.walk(tmp_path / "jax"):
        names += [os.path.relpath(os.path.join(root, f), tmp_path / "jax") for f in files]
    assert len(names) == 4 + 3
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    empty = tfactory.export_reference_csvs([], str(tmp_path / "port0"))
    jfactory.export_reference_csvs([], str(tmp_path / "jax0"))
    assert open(empty["1H"], "rb").read() == open(tmp_path / "jax0" / "data_1H_0.csv", "rb").read()


def test_cli_simulate_prints_jax_keys(tmp_path):
    """The command's line and files: JAX's keys, and CSVs that the JAX
    package's reader loads back as the port's simulated records."""
    smiles = _smiles_file(tmp_path, ["CC(=O)Nc1ccc(O)cc1", "CCO", "not a smiles"])
    rc, line = _run(tcli.main, ["simulate", "--device", "cpu", "--smiles", smiles,
                                "--out", str(tmp_path / "port")])
    jrc, ref = _run(jcli.main, ["simulate", "--smiles", smiles, "--out", str(tmp_path / "jax")])
    assert rc == jrc == 0 and set(line) == set(ref) and set(line["paths"]) == set(ref["paths"])
    assert line["n_molecules"] == ref["n_molecules"] == 2
    p = line["paths"]
    back = jdp.load_spectra_csvs(csv_1h=p["1H"], csv_13c=p["13C"], csv_hsqc=p["HSQC"],
                                 csv_cosy=p["COSY"], ir_folder=p["IR"])
    sims = tfactory.simulate_records(["CC(=O)Nc1ccc(O)cc1", "CCO"], device="cpu")
    assert [r.smiles for r in back] == [r.smiles for r in sims]
    for a, b in zip(back, sims):
        assert (a.h1, a.c13, a.hsqc, a.cosy) == (b.h1, b.c13, b.hsqc, b.cosy)
        # float32 values written in numpy's shortest form read back exactly
        np.testing.assert_array_equal(np.asarray(a.ir, np.float32), b.ir)


def _jax_keys(monkeypatch, argv, stubs: dict) -> object:
    """The JAX command's JSON line with ``stubs`` (module attribute ->
    replacement) in place of its heavy work."""
    for (mod, name), value in stubs.items():
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jcli, "_start_heartbeat", lambda tag: None)
    monkeypatch.setattr(jcli, "_load_params", lambda args, mcfg: None)
    return _run(jcli.main, argv)[1]


def test_cli_evaluate_prints_jax_keys(monkeypatch, tmp_path):
    results_path = str(tmp_path / "results.pkl")
    rc, line = _run(tcli.main, ["evaluate", "--small", "--synthetic", "3", "--device", "cpu",
                                "--max-len", "16", "--fanout", "4", "--multinom-runs", "2",
                                "--rounds", "1", "--results-out", results_path])
    ref = _jax_keys(monkeypatch, ["evaluate", "--synthetic", "2"], {
        (jh, "evaluate_molecules"): lambda *a, **k: ([], jh.EvalSummary(top_k_accuracy={1: 0.0}))})
    assert rc == 0 and set(line) == set(ref) | {"stage_seconds"}
    assert line["n"] == 3 and set(line["top_k_accuracy"]) == {"1", "3", "5", "10", "20"}
    with open(results_path, "rb") as f:
        assert [len(r.target) > 0 for r in pickle.load(f)] == [True] * 3


def test_cli_improve_prints_jax_keys_and_writes_params(monkeypatch, tmp_path):
    """One cycle of one step at the small width: JAX's keys, one line per
    cycle in cycles.jsonl, and a params.msgpack the JAX package reads."""
    smiles = _smiles_file(tmp_path, ["CCOC(=O)c1ccccc1"])
    out = tmp_path / "run"
    rc, line = _run(tcli.main, ["improve", "--small", "--device", "cpu", "--smiles", smiles,
                                "--cycles", "1", "--steps", "1", "--generations", "3",
                                "--batch-size", "4", "--out", str(out)])
    report = jic.CycleReport(0, 1, 0.5, jh.EvalSummary())
    ref = _jax_keys(monkeypatch, ["improve", "--smiles", smiles, "--out", str(tmp_path / "jax")],
                    {(jic, "run_improvement_cycle"): lambda *a, **k: (None, [report]),
                     (jckpt, "export_params_msgpack"): lambda *a, **k: None})
    assert rc == 0 and len(line) == 1 and set(line[0]) == set(ref[0])
    assert line[0]["n_augmented"] > 0 and np.isfinite(line[0]["train_loss"])
    with open(out / "cycles.jsonl") as f:
        assert [json.loads(x) for x in f] == line
    template = jmmt.init_params(ModelConfig.small(), jax.random.PRNGKey(0))
    loaded = jckpt.import_params_msgpack(template, str(out / "params.msgpack"))
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(loaded))


def test_cli_serve_loads_params_into_the_served_state(monkeypatch, tmp_path):
    """``serve --params`` loads the checkpoint into the state it serves, on
    the asked device, on the given port; ``serve`` binds every interface."""
    path = str(tmp_path / "small.msgpack")
    saved = tmmt.init_model(tconfig.ModelConfig.small(), 4, "cpu")
    tckpt.export_params_msgpack(saved, path)
    seen = {}
    monkeypatch.setattr(tserve, "serve", lambda port, state: seen.update(port=port, state=state))
    assert tcli.main(["serve", "--device", "cpu", "--small", "--params", path,
                      "--port", "8099"]) == 0
    st = seen["state"]
    assert seen["port"] == 8099 and st.device.type == "cpu"
    assert all(torch.equal(st.model.state_dict()[k], v) for k, v in saved.state_dict().items())
    st.jobs.shutdown()

    import wsgiref.simple_server as wss

    class Fake:
        def serve_forever(self):
            seen["served"] = True

    monkeypatch.setattr(wss, "make_server",
                        lambda host, port, app, server_class: seen.update(host=host, bound=port)
                        or Fake())
    state = tserve.ServerState(tconfig.ModelConfig.small(), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        tserve.app.serve(state=state)
    state.jobs.shutdown()
    assert seen["host"] == "0.0.0.0" and seen["bound"] == tserve.DEFAULT_PORT == 8083
    assert seen["served"]
