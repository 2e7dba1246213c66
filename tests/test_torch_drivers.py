"""The port's data and checkpoint drivers on the CPU: record pickles the JAX
package wrote, read without JAX (``data.pipeline.load_records_pickle``, ``cli
train --factory-cache``); the chunked sweep's shards; the factory-cache
builder; the held-out bundle regenerator; the feature-cache prewarmers; the
checkpoint averaging and the bf16 export, held to the JAX package's."""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multimodalspectraltransformer_tpu.data import pipeline as jax_dp
from multimodalspectraltransformer_tpu.models import mmt as jax_mmt
from multimodalspectraltransformer_tpu.train import checkpoint as jax_ckpt
from multimodalspectraltransformer_tpu.utils.config import ModelConfig as JaxModelConfig
from multimodalspectraltransformer_torch import cli
from multimodalspectraltransformer_torch.data import pipeline as dp
from multimodalspectraltransformer_torch.models import convert, mmt
from multimodalspectraltransformer_torch.train import checkpoint as ckpt
from multimodalspectraltransformer_torch.train.state import create_state
from multimodalspectraltransformer_torch.utils.config import ModelConfig, TrainConfig
from torch_test_support import REPO, load

R2B = os.path.join(REPO, "runs", "accuracy_r2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(r) -> tuple:
    return (r.sample_id, r.smiles, r.h1, r.c13, r.hsqc, r.cosy,
            None if r.ir is None else np.asarray(r.ir).tolist())


# the JAX package and JAX blocked before the port loads the pickle and trains
_READ_WITHOUT_JAX = r"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "multimodalspectraltransformer_tpu"):
            raise ImportError(f"blocked: {name}")
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "multimodalspectraltransformer_tpu"):
        del sys.modules[name]
sys.meta_path.insert(0, Block())
from multimodalspectraltransformer_torch import cli
from multimodalspectraltransformer_torch.data.pipeline import SampleRecord, load_records_pickle
cache, out = sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else ""
got = load_records_pickle(cache)
assert all(type(r) is SampleRecord for r in got["records"])
print("RECORDS " + json.dumps({"n": got["n"], "seed": got["seed"], "records": [
    [r.sample_id, r.smiles, r.h1, r.c13, r.hsqc, r.cosy,
     None if r.ir is None else r.ir.tolist()] for r in got["records"]]}))
if out:  # then cli train reads it and takes one step
    assert cli.main(["train", "--factory", str(got["n"]), "--factory-seed", str(got["seed"]),
                     "--factory-cache", cache, "--small", "--steps", "1", "--batch-size", "2",
                     "--device", "cpu", "--out", out]) == 0
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "multimodalspectraltransformer_tpu"))
print("LOADED:" + ",".join(bad))
"""


@pytest.mark.parametrize("numpy_paths", ["numpy2", "numpy1"])
def test_jax_written_factory_cache_is_read_and_trained_on_without_jax(tmp_path, numpy_paths):
    records = jax_dp.synthetic_dataset(6, seed=1)
    path = str(tmp_path / "factory.pkl")
    data = pickle.dumps({"n": 6, "seed": 1, "records": records}, protocol=2)
    assert b"multimodalspectraltransformer_tpu.data.pipeline\nSampleRecord" in data
    if numpy_paths == "numpy1":  # an old cache names numpy 1.x's module paths
        assert b"numpy._core.multiarray" in data
        data = data.replace(b"numpy._core.multiarray", b"numpy.core.multiarray")
    with open(path, "wb") as f:
        f.write(data)
    train = [str(tmp_path / "run")] if numpy_paths == "numpy2" else []
    proc = subprocess.run([sys.executable, "-c", _READ_WITHOUT_JAX, path, *train],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    got = json.loads(next(ln for ln in lines if ln.startswith("RECORDS "))[8:])
    assert (got["n"], got["seed"]) == (6, 1)
    assert [tuple(r) for r in got["records"]] == [_fields(r) for r in records]
    assert lines[-1] == "LOADED:"
    if train:
        train_line = json.loads(next(ln for ln in lines if ln.startswith('{"steps"')))
        assert train_line["steps"] == 1 and np.isfinite(train_line["train_loss"])


@pytest.mark.parametrize("module,name,match", [
    ("os", "system", "refusing to load it"),
    ("multimodalspectraltransformer_tpu.data.pipeline", "FeaturizeOptions",
     "only the JAX package's SampleRecord"),
])
def test_record_pickle_refuses_other_names(tmp_path, module, name, match):
    path = tmp_path / "bad.pkl"
    path.write_bytes(b"\x80\x02c" + f"{module}\n{name}\n".encode() + b")R.")
    with pytest.raises(pickle.UnpicklingError, match=match):
        dp.load_records_pickle(str(path))


def test_sweep_shards_merge_to_the_one_shard_result(tmp_path, monkeypatch):
    sweep = load("scripts/torch_eval_sweep.py")
    common = ["--synthetic", "8", "--chunk-size", "2", "--small", "--fanout", "2",
              "--multinom-runs", "1", "--rounds", "1", "--max-len", "24", "--device", "cpu"]
    assert sweep.main([*common, "--out", str(tmp_path / "one")]) == 0
    for s in (0, 1):
        assert sweep.main([*common, "--out", str(tmp_path / "two"), "--shard", str(s),
                           "--num-shards", "2"]) == 0
    one = json.load(open(tmp_path / "one" / "summary.json"))
    two = json.load(open(tmp_path / "two" / "summary.json"))
    assert (one["n"], two["n"], two["num_shards"]) == (8, 8, 2)
    for key in ("greedy_exact", "mns_exact", "mean_best_tanimoto", "mean_greedy_tanimoto"):
        assert two[key] == pytest.approx(one[key], rel=1e-12, abs=1e-15), key
    for ci in range(4):  # every chunk the same work, whichever shard ran it
        a = json.load(open(tmp_path / "one" / f"chunk_{ci:04d}.json"))
        b = json.load(open(tmp_path / "two" / f"chunk_{ci:04d}.json"))
        assert a["digest"] == b["digest"] and a["molecules"] == b["molecules"]
    assert json.load(open(tmp_path / "two" / "summary_shard1.json"))["n"] == 4
    # a rerun resumes every chunk of its shard
    from multimodalspectraltransformer_torch.eval import harness

    monkeypatch.setattr(harness, "evaluate_molecules", lambda *a, **k: pytest.fail("recomputed"))
    assert sweep.main([*common, "--out", str(tmp_path / "two"), "--shard", "0",
                       "--num-shards", "2"]) == 0


def test_cache_builder_writes_partial_and_final_files(tmp_path, monkeypatch):
    from multimodalspectraltransformer_torch.sim import factory

    builder = load("scripts/torch_build_factory_cache.py")
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("CCO\nCC(=O)Nc1ccc(O)cc1\n\nc1ccccc1C\nCCN\nOCC(=O)O\n")
    out = str(tmp_path / "factory.pkl")
    seen = []
    real = factory.simulate_records

    def spy(smiles, **kw):
        partial = out + ".partial"
        seen.append(pickle.load(open(partial, "rb"))["done"] if os.path.exists(partial) else None)
        return real(smiles, **kw)

    monkeypatch.setattr(factory, "simulate_records", spy)
    assert builder.main(["--corpus", str(corpus), "--n", "5", "--seed", "21", "--out", out,
                         "--chunk", "2", "--checkpoint-every", "1", "--device", "cpu"]) == 0
    assert seen == [None, 2, 4]
    assert not os.path.exists(out + ".partial") and not os.path.exists(out + ".tmp")
    cached = dp.load_records_pickle(out)
    assert (cached["n"], cached["seed"]) == (5, 21) and "done" not in cached
    assert [r.sample_id for r in cached["records"]] == ["f0", "f1", "f2", "f3", "f4"]


def test_regenerated_bundle_matches_the_committed_rows(tmp_path):
    regen = load("scripts/torch_regen_heldout_csv.py")
    acc = load("scripts/torch_accuracy_report.py")
    with open(os.path.join(R2B, "heldout_smiles.json")) as f:
        smiles = json.load(f)["smiles"][:3]
    (tmp_path / "h.json").write_text(json.dumps({"smiles": smiles}))
    out = str(tmp_path / "bundle.tar.gz")
    assert regen.main(["--smiles", str(tmp_path / "h.json"), "--out", out, "--device", "cpu"]) == 0
    with tarfile.open(out) as tf:
        assert {m.name.split("/")[0] for m in tf.getmembers()} == {"heldout_csv"}
    for d in ("mine", "theirs"):
        (tmp_path / d).mkdir()
    mine = acc.load_records(out, str(tmp_path / "mine"))
    theirs = {r.smiles: r for r in acc.load_records(os.path.join(R2B, "heldout_csv.tar.gz"),
                                                    str(tmp_path / "theirs"))}
    assert [r.smiles for r in mine] == smiles
    for r in mine:
        q = theirs[r.smiles]
        for attr in ("h1", "c13", "hsqc", "cosy", "ir"):
            np.testing.assert_allclose(np.asarray(getattr(r, attr), float),
                                       np.asarray(getattr(q, attr), float), rtol=0, atol=1e-4,
                                       err_msg=attr)


@pytest.fixture(scope="module")
def factory_cache(tmp_path_factory):
    """12 factory molecules simulated on the CPU into a ``--factory-cache``."""
    path = str(tmp_path_factory.mktemp("factory") / "factory.pkl")
    args = cli.build_parser().parse_args(["train", "--factory", "12", "--factory-seed", "3",
                                          "--factory-cache", path, "--out", "unused"])
    cli._factory_records(args, "cpu")
    return path


@pytest.mark.parametrize("command", ["train", "train-clip"])
def test_prewarmed_feature_cache_is_hit(tmp_path, capfd, factory_cache, command):
    fc = str(tmp_path / "featcache")
    flags = ["--factory", "12", "--factory-seed", "3", "--factory-cache", factory_cache,
             "--small", "--feature-cache", fc]
    if command == "train":
        flags += ["--val-n", "2", "--augment", "2"]
        assert load("scripts/torch_prewarm_featcache.py").main([*flags, "--device", "cpu"]) == 0
    else:
        flags += ["--eval-n", "2"]
        assert load("scripts/torch_prewarm_clip_featcache.py").main([*flags, "--device", "cpu"]) == 0
    written = os.listdir(fc)
    assert len(written) == 1 and written[0].startswith("mmt_features_")
    assert "wrote featurized cache" in capfd.readouterr().out
    assert cli.main([command, *flags, "--steps", "1", "--batch-size", "4", "--device", "cpu",
                     "--out", str(tmp_path / "run")]) == 0
    out = capfd.readouterr().out
    assert f"loaded featurized cache {os.path.join(fc, written[0])}" in out
    assert "wrote featurized cache" not in out


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Three snapshots of a small model's training state (steps 1-3, the
    parameters moved between saves) and their parameters as JAX trees."""
    d = tmp_path_factory.mktemp("run")
    model = mmt.init_model(ModelConfig.small(), 0, "cpu")
    state = create_state(TrainConfig(), model)
    mgr = ckpt.CheckpointManager(str(d / "ckpt"))
    g = torch.Generator().manual_seed(0)
    trees = []
    for step in (1, 2, 3):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=g))
        state.step = step
        assert mgr.save(state)
        # copies: the tree's arrays may share the parameters' memory
        trees.append(jax.tree.map(np.array, convert.to_jax_params(model.state_dict())))
    return str(d), trees


def test_average_matches_the_jax_float64_mean(tmp_path, snapshots):
    run_dir, trees = snapshots
    out = str(tmp_path / "avg.msgpack")
    assert load("scripts/torch_average_checkpoints.py").main(
        ["--ckpt-dir", os.path.join(run_dir, "ckpt"), "--out", out, "--last", "3",
         "--device", "cpu"]) == 0
    template = jax_mmt.init_params(JaxModelConfig.small(), jax.random.PRNGKey(0))
    got = jax_ckpt.import_params_msgpack(template, out)
    acc = None
    for t in trees:  # average_checkpoints.py:68-78
        leaves = jax.tree.map(lambda x: np.asarray(x, np.float64), t)
        acc = leaves if acc is None else jax.tree.map(np.add, acc, leaves)
    want = jax.tree.map(lambda t, a: np.asarray(a / 3.0, np.asarray(t).dtype), template, acc)
    pairs = zip(jax.tree.leaves(got), jax.tree.leaves(want))
    assert all(np.array_equal(np.asarray(a), b) for a, b in pairs)
    # --steps picks them, and a missing one fails
    assert load("scripts/torch_average_checkpoints.py").main(
        ["--ckpt-dir", os.path.join(run_dir, "ckpt"), "--out", out, "--steps", "1", "9",
         "--device", "cpu"]) == 1


@pytest.mark.parametrize("source", ["snapshot", "final"])
def test_bf16_export_equals_the_jax_export(tmp_path, snapshots, source):
    run_dir, trees = snapshots
    tree = trees[-1]
    if source == "final":
        run_dir = str(tmp_path / "run")
        os.makedirs(run_dir)
        tree = jax.tree.map(lambda x: x * np.float32(1.5), trees[0])
        ckpt.export_params_msgpack(convert.from_jax_params(tree), os.path.join(run_dir, "params.msgpack"))
    out, want = str(tmp_path / "port.msgpack.gz"), str(tmp_path / "jax.msgpack.gz")
    assert load("scripts/torch_export_latest.py").main([run_dir, out, "--device", "cpu"]) == 0
    jax_ckpt.export_params_msgpack(tree, want, dtype=jnp.bfloat16)
    import gzip

    a = serialization.msgpack_restore(gzip.open(out).read())
    b = serialization.msgpack_restore(gzip.open(want).read())
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b) and len(la) == len(lb) > 0
    assert all(x.dtype == y.dtype == jnp.bfloat16 and np.array_equal(x, y) for x, y in zip(la, lb))
