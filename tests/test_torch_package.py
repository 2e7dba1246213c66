"""The PyTorch port as a package: it imports without JAX or the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch import cli, serve
from multimodalspectraltransformer_torch.data.pipeline import Loader
from multimodalspectraltransformer_torch.decode import samplers
from multimodalspectraltransformer_torch.eval import harness, vectordb
from multimodalspectraltransformer_torch.models import mmt
from multimodalspectraltransformer_torch.ops import auction, beam_attention, decode_attention
from multimodalspectraltransformer_torch.parallel import dryrun, launch
from multimodalspectraltransformer_torch.rank import clip, matching
from multimodalspectraltransformer_torch.sim import distill, factory
from multimodalspectraltransformer_torch.train import contrastive, improvement_cycle, loop, molgen
from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig
from multimodalspectraltransformer_torch.utils.device import resolve_device
from torch_test_support import REPO, load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT_MODULES = [
    "multimodalspectraltransformer_torch." + m
    for m in ("models.convert", "models.mmt", "ops.decode_attention", "ops.auction",
              "ops.beam_attention", "ops.embedding_grad", "decode", "decode.functional", "decode.samplers",
              "eval.generation", "eval.harness", "eval.beam_bench", "rank.matching", "rank.clip",
              "rank.qformer",
              "sim.factory", "sim.distill", "sim.gnn", "data.pipeline", "data.molrandom",
              "data.samplers", "models.layers", "train.contrastive", "train.loss", "train.state",
              "train.step", "train.loop", "train.checkpoint", "train.molgen",
              "train.improvement_cycle", "serve", "serve.app", "serve.jobs", "serve.plots",
              "serve.svg", "cli", "eval.vectordb", "eval.umap", "eval.clustering", "sim.dft",
              "utils.profiling", "utils.roofline", "parallel", "parallel.mesh",
              "parallel.collectives", "parallel.launch", "parallel.dryrun")
]
DRIVER_SCRIPTS = ("torch_accuracy_report", "torch_eval_sweep", "torch_build_factory_cache",
                  "torch_regen_heldout_csv", "torch_prewarm_featcache",
                  "torch_prewarm_clip_featcache", "torch_average_checkpoints", "torch_export_latest")
CAMPAIGN_SCRIPTS = ("torch_sgnn_adapt", "torch_build_sgnn_corpus", "torch_control_adapted_sim_eval",
                    "torch_real_data_demo", "torch_r4_mem_control", "torch_zinc_corpus",
                    "torch_build_mixture_corpus", "torch_chemotype_stats", "torch_make_r3_corpus")
EXAMPLES = ("torch_01_data_generation", "torch_02_train_and_evaluate", "torch_03_explainability",
            "torch_04_improvement_cycle")
PORT_SCRIPTS = [os.path.join(REPO, "scripts", n + ".py") for n in (
    *DRIVER_SCRIPTS, *CAMPAIGN_SCRIPTS, "torch_train_sim_models", "torch_heldout_precision",
    "torch_train_determinism", "torch_roofline", "torch_roofline_report")]
PORT_SCRIPTS += [os.path.join(REPO, "examples", n + ".py") for n in EXAMPLES]
PORT_SCRIPTS += [os.path.join(REPO, n) for n in ("chip_smoke.py", "bench_torch.py")]

_BLOCKED_IMPORT = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "ninja", "optax", "orbax", "pandas",
           "sklearn", "matplotlib")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import importlib, importlib.util

for m in sys.argv[1:]:
    if m.endswith(".py"):  # a script, loaded as a module without running its main
        spec = importlib.util.spec_from_file_location("_script", m)
        mod = sys.modules["_script"] = importlib.util.module_from_spec(spec)  # for dataclasses
        spec.loader.exec_module(mod)
    else:
        importlib.import_module(m)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in BLOCKED + ("multimodalspectraltransformer_tpu",))
print("LOADED:" + ",".join(bad))
"""


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, *PORT_MODULES, *PORT_SCRIPTS],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED:", proc.stdout


def test_port_sources_never_name_jax_imports():
    """No source file of the port, chip_smoke.py, the kernel_timing.py it
    shares with scripts/torch_kernel_times.py, or the port's accuracy report
    has an import of JAX, flax, msgpack, pandas or the JAX package (the
    runtime test above covers the modules it imports; this covers every
    file)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|msgpack|ml_dtypes|ninja|pandas|"
                     r"multimodalspectraltransformer_tpu)\b", re.M)
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "kernel_timing.py",
                                             os.path.join("scripts", "torch_kernel_times.py"))]
    files += PORT_SCRIPTS
    for root, _dirs, names in os.walk(os.path.join(REPO, "multimodalspectraltransformer_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders


def _env_kept(fn):
    """``fn()`` with ``os.environ`` restored after it (``cli bench`` writes
    BENCH_BATCH and BENCH_BEAM before it raises)."""
    saved = dict(os.environ)
    try:
        return fn()
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(None),
    "load_model": lambda: mmt.load_model(os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")),
    "simulate_records": lambda: factory.simulate_records(["CCO"]),
    "greedy_decode": lambda: samplers.greedy_decode(
        {}, ModelConfig(), torch.zeros(1, 2, 128), torch.zeros(1, 2, dtype=torch.bool)),
    "multinomial_decode": lambda: samplers.multinomial_decode(
        {}, ModelConfig(), torch.zeros(1, 2, 128), torch.zeros(1, 2, dtype=torch.bool),
        torch.Generator()),
    "beam_search": lambda: samplers.beam_search(
        {}, ModelConfig(), torch.zeros(1, 2, 128), torch.zeros(1, 2, dtype=torch.bool)),
    "beam_search_materialized": lambda: samplers.beam_search_materialized(
        {}, ModelConfig(), torch.zeros(1, 2, 128), torch.zeros(1, 2, dtype=torch.bool)),
    "dummy_batch": lambda: mmt.dummy_batch(ModelConfig(), 2),
    "evaluate_molecules": lambda: harness.evaluate_molecules(
        [], mmt.MultimodalTransformer(ModelConfig.small())),
    "batched_pairwise_assignment_error": lambda: matching.batched_pairwise_assignment_error(
        [np.ones((2, 2))], [np.ones((2, 2))]),
    "batched_assignment_error": lambda: matching.batched_assignment_error(
        np.ones((2, 2)), np.ones((1, 2, 2)), 2, np.array([2])),
    "batched_assignment_error_pallas": lambda: auction.batched_assignment_error_pallas(
        np.ones((2, 2)), np.ones((1, 2, 2)), 2, np.array([2])),
    "assignment_cost": lambda: auction.assignment_cost(np.ones((1, 2, 2))),
    "clip_load_bundle": lambda: clip.load_bundle(os.path.join(REPO, "weights", "clip_r4.msgpack.gz")),
    "init_model": lambda: mmt.init_model(ModelConfig.small()),
    "device_dataset": lambda: Loader([], ModelConfig.small(), 1).device_dataset(),
    "run_training": lambda: loop.run_training(MMTConfig(model=ModelConfig.small()),
                                              Loader([], ModelConfig.small(), 1)),
    "cli_train": lambda: cli.main(["train", "--synthetic", "4", "--out", "never-written"]),
    "cli_simulate": lambda: cli.main(["simulate", "--smiles", "never-read.txt",
                                      "--out", "never-written"]),
    "cli_evaluate": lambda: cli.main(["evaluate", "--synthetic", "2"]),
    "cli_improve": lambda: cli.main(["improve", "--smiles", "never-read.txt",
                                     "--out", "never-written"]),
    "cli_serve": lambda: cli.main(["serve"]),
    "cli_bench": lambda: _env_kept(lambda: cli.main(["bench"])),
    "bench_e2e": lambda: load("bench_torch.py").main_e2e(),
    "bench_beam": lambda: load("bench_torch.py").main_beam(),
    "roofline_report": lambda: load("scripts/torch_roofline_report.py").main([]),
    "launch": lambda: launch.launch("time:sleep", 1, args=(0,)),
    "dryrun_multichip": lambda: dryrun.dryrun_multichip(2),
    "dryrun_cli": lambda: dryrun.main(["2"]),
    "server_state": lambda: serve.ServerState(),
    "make_app": lambda: serve.make_app(),
    "sample_model_neighbors": lambda: molgen.sample_model_neighbors(
        mmt.MultimodalTransformer(ModelConfig.small()), "CCO"),
    "sample_model_neighbors_batch": lambda: molgen.sample_model_neighbors_batch(
        mmt.MultimodalTransformer(ModelConfig.small()), []),
    "run_improvement_cycle": lambda: improvement_cycle.run_improvement_cycle(
        MMTConfig(model=ModelConfig.small()), [], {}),
    "train_contrastive": lambda: contrastive.train_contrastive(
        MMTConfig(model=ModelConfig.small()), {}, []),
    "retrieval_accuracy": lambda: contrastive.retrieval_accuracy(
        None, MMTConfig(model=ModelConfig.small()), {}, []),
    "cli_train_clip": lambda: cli.main(["train-clip", "--synthetic", "4"]),
    "train_shift_model": lambda: distill.train_shift_model({"n_atoms": np.zeros(2)}),
    "train_ir_model": lambda: distill.train_ir_model({"n_atoms": np.zeros(2)}),
    "build_model_db": lambda: vectordb.build_model_db([], mmt.MultimodalTransformer(
        ModelConfig.small())),
    "vectordb_query": lambda: vectordb.query(vectordb.VectorDB(["C"], np.ones((1, 8))),
                                             np.ones((1, 8))),
    "cli_vectorize": lambda: cli.main(["vectorize", "--smiles", "never-read.txt",
                                       "--out", "never-written"]),
    "accuracy_report": lambda: load("scripts/torch_accuracy_report.py").main(
        ["--n", "1", "--out", "never-written"]),
    "eval_sweep": lambda: load("scripts/torch_eval_sweep.py").main(
        ["--synthetic", "2", "--out", "never-written"]),
    "build_factory_cache": lambda: load("scripts/torch_build_factory_cache.py").main(
        ["--corpus", "never-read.txt", "--n", "1", "--seed", "0", "--out", "never-written"]),
    "regen_heldout_csv": lambda: load("scripts/torch_regen_heldout_csv.py").main(
        ["--smiles", "never-read.json", "--out", "never-written"]),
    "prewarm_featcache": lambda: load("scripts/torch_prewarm_featcache.py").main(
        ["--factory", "4", "--factory-cache", "never-read.pkl", "--feature-cache", "never-written"]),
    "prewarm_clip_featcache": lambda: load("scripts/torch_prewarm_clip_featcache.py").main(
        ["--factory", "4", "--factory-cache", "never-read.pkl", "--feature-cache", "never-written"]),
    "average_checkpoints": lambda: load("scripts/torch_average_checkpoints.py").main(
        ["--ckpt-dir", "never-read", "--out", "never-written"]),
    "export_latest": lambda: load("scripts/torch_export_latest.py").main(["never-read", "never-written"]),
    "sgnn_adapt": lambda: load("scripts/torch_sgnn_adapt.py").main(
        ["--ref-dir", "never-read", "--out", "never-written", "--report", "never-written"]),
    "build_sgnn_corpus": lambda: load("scripts/torch_build_sgnn_corpus.py").main(
        ["--ref-dir", "never-read", "--out", "never-written"]),
    "control_adapted_sim_eval": lambda: load("scripts/torch_control_adapted_sim_eval.py").main(
        ["--params", "never-read", "--ref-dir", "never-read", "--out", "never-written"]),
    "real_data_demo": lambda: load("scripts/torch_real_data_demo.py").main(
        ["--params", "never-read", "--dir", "never-read", "--out", "never-written"]),
    "train_determinism": lambda: load("scripts/torch_train_determinism.py").main(
        ["--reps", "1", "--det-reps", "0", "--out", "never-written"]),
    "example_01": lambda: load("examples/torch_01_data_generation.py").main("never-written"),
    "example_02": lambda: load("examples/torch_02_train_and_evaluate.py").main(),
    "example_03": lambda: load("examples/torch_03_explainability.py").main("never-written.svg"),
    "example_04": lambda: load("examples/torch_04_improvement_cycle.py").main(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(monkeypatch, name):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_entry_points_run_on_cpu_when_asked():
    assert resolve_device("cpu").type == "cpu"
    recs = factory.simulate_records(["CCO"], device="cpu")
    assert len(recs) == 1 and recs[0].hsqc and recs[0].ir is not None
    err = matching.batched_pairwise_assignment_error([np.ones((2, 2))], [np.ones((2, 2))],
                                                     device="cpu")
    assert err.shape == (1,) and abs(err[0]) < 1e-6


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    """On the CPU the wrappers compute the plain version and count no launch;
    on another device type they raise instead of falling back."""
    decode_attention.reset_launches()
    auction.reset_launches()
    beam_attention.reset_launches()
    q = torch.randn(2, 4, 8)
    kv = torch.randn(2, 4, 16, 6)
    out = decode_attention.decode_attention(q, kv, 3)
    torch.testing.assert_close(out, decode_attention.decode_attention_plain(q, kv, 3))
    cost = torch.rand(3, 8, 8)
    torch.testing.assert_close(auction.auction_assignment_cost(cost),
                               auction.auction_assignment_cost_plain(cost))
    qb, kvb, bias = _beam_inputs()
    torch.testing.assert_close(beam_attention.beam_attention(qb, kvb, bias, 6),
                               beam_attention.beam_attention_plain(qb, kvb, bias, 6))
    assert decode_attention.launches == 0 and auction.launches == 0 and beam_attention.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention.decode_attention(q.to("meta"), kv.to("meta"), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        auction.auction_assignment_cost(cost.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        beam_attention.beam_attention(qb.to("meta"), kvb.to("meta"), bias.to("meta"), 6)


def _beam_inputs():
    """q [2, 4, 3, 8], kv [2, 4, 16, 9] (T = 3 steps of K = 3 lanes), and a
    bias keeping each beam's own lane at every step."""
    bias = torch.full((2, 3, 9), float("-inf"))
    for k in range(3):
        bias[:, k, k::3] = 0.0
    return torch.randn(2, 4, 3, 8), torch.randn(2, 4, 16, 9), bias


@pytest.mark.parametrize("bad", ["shape", "dtype", "pos"])
def test_decode_attention_checks_its_inputs(bad):
    q = torch.randn(2, 4, 8)
    kv = torch.randn(2, 4, 16, 6)
    pos = 3
    if bad == "shape":
        kv = torch.randn(2, 4, 8, 6)
    elif bad == "dtype":
        q = q.double()
    else:
        pos = 6
    with pytest.raises((ValueError, TypeError)):
        decode_attention.decode_attention(q, kv, pos)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_auction_checks_its_inputs(bad):
    cost = torch.rand(2, 8, 6) if bad == "shape" else torch.rand(2, 8, 8).double()
    with pytest.raises((ValueError, TypeError)):
        auction.auction_assignment_cost(cost)


@pytest.mark.parametrize("bad", ["shape", "bias_shape", "dtype", "n_live"])
def test_beam_attention_checks_its_inputs(bad):
    q, kv, bias = _beam_inputs()
    n_live = 6
    if bad == "shape":
        kv = torch.randn(2, 4, 8, 9)
    elif bad == "bias_shape":
        bias = bias[:, :2]
    elif bad == "dtype":
        bias = bias.to(torch.bfloat16)
    else:
        n_live = 10
    with pytest.raises((ValueError, TypeError)):
        beam_attention.beam_attention(q, kv, bias, n_live)


@pytest.mark.parametrize("weights", ["present", "missing"])
def test_chip_smoke_refuses_the_rule_based_simulator(monkeypatch, tmp_path, weights):
    """``chip_smoke.py`` fails, naming the weights directory, when the
    simulator's GNN weights do not load (the factory would fall back to its
    rule teachers); with the committed weights it goes on."""
    import functools

    import chip_smoke
    from multimodalspectraltransformer_torch.sim import distill

    monkeypatch.setattr(factory, "_defaults", {})
    if weights == "missing":
        for name in ("load_shift_weights", "load_ir_weights"):
            monkeypatch.setattr(distill, name,
                                functools.partial(getattr(distill, name), str(tmp_path / "none")))
        with pytest.raises(RuntimeError, match="shift and IR GNN weights are missing: .*"
                                               + os.path.join("sim", "weights")):
            chip_smoke.require_simulator_weights("cpu")
    else:
        chip_smoke.require_simulator_weights("cpu")
