"""The port's headline bench (``bench_torch.py``, ``cli bench``) against
``bench.py`` on the CPU.

``bench.py`` is never imported here: its import rewrites JAX's global
configuration. Its constants (the weight files' preference orders, the
``DecodeConfig`` of the e2e mode, the corpus call, the keys of its JSON
lines) are read from its source with ``ast``, and the JAX side is built from
them with the JAX package's own functions. Tolerances: the simulated records
as ``tests/test_torch_sim.py`` states them (13C, HSQC and COSY peaks within
1e-6 after the factory's rounding, 1H within 1e-3, IR within 1e-4); the JSON
line's arithmetic exactly, from the rep seconds the bench prints on stderr.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import bench_torch
from multimodalspectraltransformer_torch import cli
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig
from multimodalspectraltransformer_tpu.data import molrandom as jmolrandom
from multimodalspectraltransformer_tpu.sim import factory as jfactory
from multimodalspectraltransformer_tpu.utils.config import DecodeConfig as JDecodeConfig
from torch_test_support import REPO

BENCH_VARS = ("BENCH_MODE", "BENCH_BATCH", "BENCH_BEAM", "BENCH_MAX_LEN", "BENCH_REPS",
              "BENCH_MOLS", "BENCH_PARAMS", "BENCH_DTYPE", "BENCH_E2E_REPS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _bench_env(monkeypatch):
    """No BENCH_* variable of the shell reaches a test; what a test (or ``cli
    bench``) sets is undone after it."""
    for var in BENCH_VARS:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


# ---- bench.py's constants, read from its source ---------------------------

def _bench_py() -> dict[str, ast.FunctionDef]:
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _for_tuples(fn: ast.FunctionDef) -> list[tuple]:
    """The literal tuples that ``for name in (...)`` loops of ``fn`` walk, in
    source order."""
    loops = sorted((n for n in ast.walk(fn) if isinstance(n, ast.For)
                    and isinstance(n.iter, ast.Tuple)), key=lambda n: n.lineno)
    return [ast.literal_eval(n.iter) for n in loops]


def _call(fn: ast.FunctionDef, name: str) -> ast.Call:
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", getattr(n.func, "attr", None)) == name]
    assert len(calls) == 1, name
    return calls[0]


def _env_default(fn: ast.FunctionDef, var: str) -> str:
    """The default of ``os.environ.get(var, default)`` in ``fn``."""
    for n in ast.walk(fn):
        if (isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "get" and n.args
                and isinstance(n.args[0], ast.Constant) and n.args[0].value == var):
            return ast.literal_eval(n.args[1])
    raise AssertionError(f"bench.py reads no {var}")


def _json_keys(fn: ast.FunctionDef) -> list[str]:
    dicts = [n.args[0] for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps" and isinstance(n.args[0], ast.Dict)]
    assert len(dicts) == 1
    return [k.value for k in dicts[0].keys]


def test_e2e_inputs_equal_bench_py(monkeypatch, tmp_path):
    """The SMILES, the weight file bench.py would pick (and its ``none`` and
    explicit forms), the CLIP bundle path and the DecodeConfig, exactly."""
    fns = _bench_py()
    e2e = fns["main_e2e"]
    params_order, clip_order = _for_tuples(e2e)
    assert bench_torch.PARAMS_FILES == params_order
    assert bench_torch.CLIP_FILES == clip_order

    # the molecules: random_corpus(n * 2, seed=123)[:n] at bench.py's default n
    n = int(_env_default(e2e, "BENCH_MOLS"))
    corpus = _call(e2e, "random_corpus")
    assert ast.unparse(corpus.args[0]) == "n_mols * 2"
    assert [(k.arg, ast.literal_eval(k.value)) for k in corpus.keywords] == [("seed", 123)]
    assert bench_torch.e2e_smiles(n) == jmolrandom.random_corpus(n * 2, seed=123)[:n]

    # the weight files, in the repository and where only some exist
    def first(order):
        found = [os.path.join(REPO, "weights", f) for f in order
                 if os.path.exists(os.path.join(REPO, "weights", f))]
        return found[0] if found else ""

    assert bench_torch.resolve_params_path() == first(params_order)
    assert bench_torch.resolve_params_path().endswith("mmt_r4_phase3.msgpack.gz")
    assert bench_torch.resolve_clip_path() == first(clip_order)
    assert bench_torch.resolve_clip_path().endswith("clip_r4.msgpack.gz")
    for value in ("none", "untrained", "NONE"):
        monkeypatch.setenv("BENCH_PARAMS", value)
        assert bench_torch.resolve_params_path() == ""
    monkeypatch.setenv("BENCH_PARAMS", "some/params.msgpack")
    assert bench_torch.resolve_params_path() == "some/params.msgpack"
    monkeypatch.delenv("BENCH_PARAMS")
    monkeypatch.setattr(bench_torch, "REPO", str(tmp_path))
    assert bench_torch.resolve_params_path() == "" and bench_torch.resolve_clip_path() == ""
    (tmp_path / "weights").mkdir()
    for name in (params_order[-1], params_order[1], clip_order[-1]):
        (tmp_path / "weights" / name).write_bytes(b"")
    assert bench_torch.resolve_params_path() == str(tmp_path / "weights" / params_order[1])
    assert bench_torch.resolve_clip_path() == str(tmp_path / "weights" / clip_order[-1])

    # the DecodeConfig, BENCH_DTYPE's default and a value of it
    dc = _call(e2e, "DecodeConfig")
    kw = {k.arg: k.value for k in dc.keywords}
    dtype_default = ast.literal_eval(kw.pop("compute_dtype").args[1])
    kw = {k: ast.literal_eval(v) for k, v in kw.items()}
    for dtype in (None, "float32"):
        if dtype:
            monkeypatch.setenv("BENCH_DTYPE", dtype)
        ref = JDecodeConfig(**kw, compute_dtype=dtype or dtype_default)
        assert dataclasses.asdict(bench_torch.decode_config()) == dataclasses.asdict(ref)


def test_e2e_records_equal_jax_factory():
    """The trained mode's 48 records, simulated by the port, against the JAX
    factory's, at tests/test_torch_sim.py's tolerances."""
    smiles = bench_torch.e2e_smiles(48)
    ref = jfactory.simulate_records(smiles)
    ours = tfactory.simulate_records(smiles, device="cpu")
    assert len(ours) == len(ref) == 48
    assert [r.smiles for r in ours] == [r.smiles for r in ref]
    assert [r.sample_id for r in ours] == [r.sample_id for r in ref]
    for a, b in zip(ref, ours):
        for key in ("c13", "hsqc", "cosy"):
            x, y = getattr(a, key), getattr(b, key)
            assert (x is None) == (y is None), (a.smiles, key)
            if x is not None:
                np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-6,
                                           err_msg=f"{a.smiles} {key}")
        np.testing.assert_allclose(np.asarray(b.h1), np.asarray(a.h1), atol=1e-3)
        np.testing.assert_allclose(b.ir, np.asarray(a.ir), atol=1e-4)


# ---- the JSON line ---------------------------------------------------------

def _line_and_detail(capfd) -> tuple[dict, dict]:
    """The one stdout line (exactly one) and the bench's ``detail`` line."""
    out, err = capfd.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    details = [ln for ln in err.splitlines() if ln.startswith("[bench] detail ")]
    assert len(details) == 1, err
    return json.loads(lines[0]), json.loads(details[0][len("[bench] detail "):])


def _check_arithmetic(line: dict, detail: dict, n: int, keys: list[str]) -> None:
    assert list(line) == keys
    assert line["unit"] == "mols/sec/chip"
    best = min(detail["reps_s"])
    assert detail["n"] == n and detail["best_s"] == best
    assert line["value"] == round(n / best, 3) > 0
    assert line["vs_baseline"] == round(n / best / bench_torch.BASELINE_MOLS_PER_SEC, 1)
    if "mols_per_sec_mean" in keys:
        mean = sum(detail["reps_s"]) / len(detail["reps_s"])
        assert line["mols_per_sec_mean"] == round(n / mean, 3)
    assert detail["card"] == "cpu (no card)" and detail["max_memory_allocated"] is None
    assert all(c == {"K1": 0, "K2": 0, "K3": 0} for c in detail["launches"])  # plain versions


def test_e2e_line_untrained_small_config(monkeypatch, tmp_path, capfd):
    """No committed weights: untrained weights, injected candidates and a
    random 2-layer CLIP tower, as bench.py falls back; the line's keys are
    bench.py's e2e keys and its numbers follow from the printed reps."""
    keys = _json_keys(_bench_py()["main_e2e"])
    monkeypatch.setattr(bench_torch, "REPO", str(tmp_path))
    dcfg = DecodeConfig(max_len=12, fanout=4, multinom_runs=3, max_temp_rounds=2,
                        compute_dtype="bfloat16")
    line = bench_torch.main_e2e("cpu", n_mols=2, reps=2, cfg=ModelConfig.small(), dcfg=dcfg)
    got, detail = _line_and_detail(capfd)
    assert got == line
    _check_arithmetic(line, detail, 2, keys)
    assert len(detail["reps_s"]) == 2
    assert "untrained weights, injected candidates" in line["metric"]
    assert "random-init 2-layer CLIP" in line["metric"] and "best of 2 reps" in line["metric"]
    assert {"encode", "greedy", "sampling", "clip", "simulate", "score"} <= set(
        detail["stage_seconds"])


def test_beam_line_small_config(monkeypatch, capfd):
    keys = _json_keys(_bench_py()["main"])
    for var, value in (("BENCH_BATCH", "3"), ("BENCH_BEAM", "2"), ("BENCH_MAX_LEN", "5"),
                       ("BENCH_REPS", "2")):
        monkeypatch.setenv(var, value)
    line = bench_torch.main_beam("cpu", ModelConfig.small())
    got, detail = _line_and_detail(capfd)
    assert got == line
    _check_arithmetic(line, detail, 3, keys)
    assert keys == ["metric", "value", "unit", "vs_baseline"]
    assert "beam2" in line["metric"] and "len 5, batch 3" in line["metric"]
    assert set(detail["stage_seconds"]) == {"encode", "beam", "total"}


def test_cli_bench_e2e_on_cpu(monkeypatch, capfd):
    """``cli bench --device cpu`` in e2e mode at full width with the committed
    phase3 and clip_r4, on 1 molecule and 1 rep."""
    monkeypatch.setenv("BENCH_MOLS", "1")
    monkeypatch.setenv("BENCH_E2E_REPS", "1")
    assert cli.main(["bench", "--device", "cpu"]) == 0
    line, detail = _line_and_detail(capfd)
    _check_arithmetic(line, detail, 1, _json_keys(_bench_py()["main_e2e"]))
    assert "trained checkpoint mmt_r4_phase3.msgpack.gz" in line["metric"]
    assert "trained CLIP ranker" in line["metric"]


def test_cli_bench_flags_win_over_stale_exports(monkeypatch, capfd):
    """``--batch`` and ``--beam`` are written into BENCH_BATCH and BENCH_BEAM
    over stale values (beam mode at full width, 3 steps)."""
    for var, value in (("BENCH_MODE", "beam"), ("BENCH_BATCH", "7"), ("BENCH_BEAM", "4"),
                       ("BENCH_MAX_LEN", "3"), ("BENCH_REPS", "1")):
        monkeypatch.setenv(var, value)
    assert cli.main(["bench", "--device", "cpu", "--batch", "2", "--beam", "2"]) == 0
    assert os.environ["BENCH_BATCH"] == "2" and os.environ["BENCH_BEAM"] == "2"
    line, detail = _line_and_detail(capfd)
    _check_arithmetic(line, detail, 2, ["metric", "value", "unit", "vs_baseline"])
    assert "beam2" in line["metric"] and "len 3, batch 2" in line["metric"]
    args = cli.build_parser().parse_args(["bench"])
    assert (args.batch, args.beam, args.device) == (128, 5, "cuda")
