"""Data and tensor parallelism of the port (``parallel/``) on the CPU over gloo.

The ranks are subprocesses started by ``parallel/launch.py``; what they run is
in ``tests/torch_parallel_ranks.py``, which imports no JAX. Each rank's result
comes back here and is held against the port's one-process run and the JAX
package's mesh (its 8-device virtual CPU mesh) on the same inputs, made from
seeds with numpy:

- meshes (layout, names, errors), the Megatron rules and the Loader's
  sharding index-exact to JAX;
- a train step over 2, 4 and 8 ranks (data, multi-slice, tensor parallel)
  against one process with dropout on, and against JAX's mesh step with
  dropout off: loss within 2e-5 relative, gradients within 5e-5 of each
  leaf's largest magnitude (``tests/test_multislice.py``'s bounds);
- ``run_training(mesh=...)`` against one process, rank 0 alone writing, the
  tensor-parallel checkpoint read by the JAX package;
- the sharded device dataset and sharded fan-out decoding.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from multimodalspectraltransformer_torch import parallel as tpar
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.parallel import mesh as tmesh
from multimodalspectraltransformer_torch.parallel.launch import launch
from multimodalspectraltransformer_torch.train import checkpoint as tckpt
from multimodalspectraltransformer_torch.train import loop as tloop
from multimodalspectraltransformer_torch.train import state as tstate
from multimodalspectraltransformer_torch.train import step as tstep
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu import parallel as jpar
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.train import checkpoint as jckpt
from multimodalspectraltransformer_tpu.train import create_state as jcreate_state
from multimodalspectraltransformer_tpu.train import step as jstep
from multimodalspectraltransformer_tpu.utils.config import MMTConfig, ModelConfig, TrainConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_multislice.py's width: 1+1 layers, ffn_dim 64 (16 heads of 8)
MCFG = ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64)
LR = 1e-3
LOSS_RTOL, GRAD_TOL = 2e-5, 5e-5


def _torch_cfg(cfg: MMTConfig) -> tconfig.MMTConfig:
    m = cfg.model
    mods = tconfig.ModalityConfig(**dataclasses.asdict(m.modalities))
    fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m) if f.name != "modalities"}
    return tconfig.MMTConfig(model=tconfig.ModelConfig(modalities=mods, **fields),
                             train=tconfig.TrainConfig(**dataclasses.asdict(cfg.train)))


def _cfg(dropout: float, **train) -> MMTConfig:
    return MMTConfig(model=dataclasses.replace(MCFG, dropout=dropout),
                     train=TrainConfig(learning_rate=LR, fast_dropout_rng=False, **train))


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters and an 8-row featurized batch (numpy)."""
    params = jmmt.init_params(MCFG, jax.random.PRNGKey(0))
    batch = jdp.collate([jdp.featurize(r, MCFG) for r in jdp.synthetic_dataset(8, seed=2)])
    sd = {k: v.numpy() for k, v in tconvert.from_jax_params(params).items()}
    return params, batch, sd


def _one_process_step(cfg: tconfig.MMTConfig, sd: dict, batch, seed: int = 0):
    model = ranks._model(cfg.model, sd)
    state = tstate.create_state(cfg.train, model)
    state, m = tstep.train_step(cfg, state, ranks._rows(batch, slice(None)), seed)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    return m, grads, {k: v.numpy() for k, v in model.state_dict().items()}


def _assert_step(got: dict, loss: float, grads: dict):
    """Loss within 2e-5 relative; each gradient within 5e-5 of its leaf's
    largest magnitude (a leaf without a gradient must have a zero one)."""
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (got["loss"], loss)
    assert set(got["grads"]) <= set(grads)
    for name, g in grads.items():
        if name not in got["grads"]:
            assert not np.any(g), name
            continue
        scale = max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(got["grads"][name] / scale, g / scale, atol=GRAD_TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# meshes and rules, against JAX (no ranks)
# ---------------------------------------------------------------------------

MESHES = [(None, -1, 1), (None, -1, 2), (None, 4, 2), (None, 2, 4), (None, 8, 1),
          (2, 2, 2), (2, -1, 2), (2, -1, 1), (4, 1, 2)]


@pytest.mark.parametrize("slices,data,model", MESHES)
def test_mesh_layout_matches_jax(slices, data, model):
    """Every rank sits where JAX puts the device of the same id."""
    devices = jax.devices()[:8]
    if slices is None:
        jm = jpar.make_mesh(data=data, model=model, devices=devices)
        names = (tpar.DATA_AXIS, tpar.MODEL_AXIS)
    else:
        jm = jpar.make_multislice_mesh(slices, data=data, model=model, devices=devices)
        names = (tpar.DCN_AXIS, tpar.DATA_AXIS, tpar.MODEL_AXIS)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(tmesh.mesh_layout(8, data, model, slices), ids)
    assert tuple(jm.axis_names) == names


@pytest.mark.parametrize("slices,data,model", [(None, 3, 1), (None, -1, 3), (3, -1, 1),
                                               (2, 3, 2)])
def test_mesh_errors_match_jax(slices, data, model):
    devices = jax.devices()[:8]
    with pytest.raises(AssertionError) as jerr:
        if slices is None:
            jpar.make_mesh(data=data, model=model, devices=devices)
        else:
            jpar.make_multislice_mesh(slices, data=data, model=model, devices=devices)
    with pytest.raises(ValueError) as terr:
        tmesh.mesh_layout(8, data, model, slices)
    assert str(terr.value) == str(jerr.value)


def test_param_shardings_cover_jax_rules():
    """The same leaves split on the same axes as JAX's ``param_shardings``,
    through the converter's name map (flax kernels are the transpose of torch
    weights); and each rank's ``in_proj`` shard holds q, k and v of its heads."""
    from torch.distributed.tensor import Replicate, Shard

    params = jmmt.init_params(MCFG, jax.random.PRNGKey(0))
    jmesh = jpar.make_mesh(data=4, model=2)
    jspecs = {"/".join(str(getattr(k, "key", k)) for k in kp): s.spec for kp, s in
              jax.tree_util.tree_flatten_with_path(jpar.param_shardings(jmesh, params, True))[0]}
    sd = tconvert.from_jax_params(params)
    placements = tpar.param_shardings(None, sd, tensor_parallel=True)
    paths = tconvert.jax_paths(sd)
    n_split = 0
    for name, t in sd.items():
        spec = list(jspecs[paths[name]])
        axis = [i - len(spec) for i, a in enumerate(spec) if a == "model"]  # from the right
        if paths[name].endswith("kernel") and axis:  # flax [in, out] = torch [out, in]
            axis = [{-1: -2, -2: -1}[axis[0]]]
        p = placements[name]
        if axis:
            n_split += 1
            assert p == Shard(t.ndim + axis[0]), (name, p, spec)
        else:
            assert p == Replicate(), (name, p, spec)
    # six split leaves a layer (in_proj weight and bias, out_proj, linear1
    # weight and bias, linear2): five modality encoders, the fusion encoder and
    # the decoder with its second attention
    assert n_split == 5 * 6 + 6 + 9
    assert all(p == Replicate() for p in tpar.param_shardings(None, sd).values())

    # the shards of an in_proj leaf put back in order, and rank 1's q rows are heads 8-15
    w = sd["decoder.layers.0.self_attn.in_proj_weight"]
    parts = [tmesh.tp_slice("x.in_proj_weight", w, r, 2) for r in range(2)]
    assert torch.equal(tmesh.tp_unslice("x.in_proj_weight", parts), w)
    assert torch.equal(parts[1][:64], w[64:128])
    assert torch.equal(parts[1][64:128], w[128 + 64 : 256])


@pytest.mark.parametrize("host_id,host_count,strategy", [(0, 2, "shuffle"), (1, 2, "shuffle"),
                                                         (2, 3, "weight_sorted"),
                                                         (1, 3, "tanimoto")])
def test_loader_host_slices_match_jax(host_id, host_count, strategy):
    """``_host_slice``, ``len`` and every batch of ``epoch`` equal JAX's for
    the host's block (the featurization stream is seeded with the host id)."""
    recs = jdp.synthetic_dataset(22, seed=5)
    kw = dict(batch_size=3, seed=4, host_id=host_id, host_count=host_count,
              order_strategy=strategy)
    jl = jdp.Loader(recs, MCFG, **kw)
    tl = tdp.Loader(recs, _torch_cfg(MMTConfig(model=MCFG)).model, **kw)
    order = list(range(22))
    assert tl._host_slice(order) == jl._host_slice(order)
    assert len(tl) == len(jl)
    jb, tb = list(jl.epoch(1)), list(tl.epoch(1))
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a.trg_tokens, b.trg_tokens)
        np.testing.assert_array_equal(a.inputs.src_13c, b.inputs.src_13c)


def test_loader_parts_are_the_rows_of_each_batch():
    """``epoch(e, part=(i, n))`` yields block i of every batch."""
    recs = jdp.synthetic_dataset(12, seed=6)
    tcfg = _torch_cfg(MMTConfig(model=MCFG)).model
    whole = list(tdp.Loader(recs, tcfg, batch_size=4, seed=3).epoch(0))
    parts = [list(tdp.Loader(recs, tcfg, batch_size=4, seed=3).epoch(0, (i, 2))) for i in range(2)]
    for k, b in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][k].trg_tokens, parts[1][k].trg_tokens]), b.trg_tokens)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        next(tdp.Loader(recs, tcfg, batch_size=4, seed=3).epoch(0, (0, 3)))


STOCHASTIC = dict(blank_percentage=0.3, randomize_smiles=True, hsqc_noise_max=3)


@pytest.mark.parametrize("opts", [STOCHASTIC, {}], ids=["stochastic", "deterministic"])
def test_loader_parts_featurize_only_their_rows(monkeypatch, opts):
    """Blanking, random SMILES forms and HSQC noise, two records whose
    chemistry fails, and a short last batch: the whole batches equal JAX's,
    each rank's block equals its rows of them in every field (exact), and the
    ranks together featurize each row once."""
    recs = jdp.synthetic_dataset(16, seed=6)
    for k in (3, 9):
        recs[k] = dataclasses.replace(recs[k], smiles="C1CC(")
    tcfg = _torch_cfg(MMTConfig(model=MCFG)).model
    kw = dict(batch_size=4, seed=3, drop_remainder=False)
    tl = tdp.Loader(recs, tcfg, opts=tdp.FeaturizeOptions(**opts), **kw)
    jl = jdp.Loader(recs, MCFG, opts=jdp.FeaturizeOptions(**opts), **kw)
    whole = [b for e in (0, 1) for b in tl.epoch(e)]
    jwhole = [b for e in (0, 1) for b in jl.epoch(e)]
    calls = [0]
    real = tdp.featurize

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(tdp, "featurize", counting)
    ranks_ = [tdp.Loader(recs, tcfg, opts=tdp.FeaturizeOptions(**opts), **kw) for _ in range(2)]
    parts = [[b for b in ldr.epoch(0, (i, 2))] for i, ldr in enumerate(ranks_)]
    assert calls[0] == 14
    # the second epoch takes each record's canonical form from the first, and
    # deterministic features from the cache
    for i, ldr in enumerate(ranks_):
        parts[i] += list(ldr.epoch(1, (i, 2)))
    assert calls[0] == 28 if opts else calls[0] < 28
    assert [len(b.trg_tokens) for b in whole] == [4, 4, 4, 2] * 2
    for k, (b, jb) in enumerate(zip(whole, jwhole)):
        for name, x in [*zip(tdp.MMTBatch._fields, b.inputs), ("trg_tokens", b.trg_tokens),
                        ("trg_fp", b.trg_fp)]:
            jx = getattr(jb.inputs, name) if name in tdp.MMTBatch._fields else getattr(jb, name)
            np.testing.assert_array_equal(np.asarray(x), np.asarray(jx), err_msg=name)
            pick = lambda bt: getattr(bt.inputs, name) if name in tdp.MMTBatch._fields else getattr(
                bt, name)
            np.testing.assert_array_equal(
                np.concatenate([pick(parts[0][k]), pick(parts[1][k])]), x, err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_epoch_row_batches_sharded_match_jax(n_shards):
    """Index-exact to JAX: segment d of each batch from shard d's partition."""
    recs = jdp.synthetic_dataset(4 * n_shards + 1, seed=7)  # the last row is dropped
    jl = jdp.Loader(recs, MCFG, batch_size=2 * n_shards, seed=3, order_strategy="weight_sorted")
    assert jl.device_dataset_sharded(jpar.make_mesh(data=n_shards, model=8 // n_shards)) is not None
    tl = tdp.Loader(recs, _torch_cfg(MMTConfig(model=MCFG)).model, batch_size=2 * n_shards,
                    seed=3, order_strategy="weight_sorted")
    tl._device_kept_smiles = [r.smiles for r in recs][: 4 * n_shards]
    for epoch in (0, 3):
        ja = list(jl.epoch_row_batches_sharded(epoch, n_shards))
        ta = list(tl.epoch_row_batches_sharded(epoch, n_shards))
        assert len(ja) == len(ta) == 2
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_init_distributed_refuses_what_it_cannot_do(monkeypatch):
    """NCCL without cards, and ranks sharing a card over NCCL, raise: nothing
    switches backend or device on its own."""
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="needs CUDA devices"):
        tpar.init_distributed(backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.init_distributed(device="cuda")


def test_launch_raises_with_the_failing_rank():
    """A rank's error fails the launch, with that rank's output; a launch that
    outlives its timeout fails too."""
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 exited with 1(.|\n)*rank 1 gives up"):
        launch("torch_parallel_ranks:fail_on", 2, args=(1,), device="cpu")
    with pytest.raises(RuntimeError, match="outlived 0.5 s"):
        launch("time:sleep", 1, args=(30,), device="cpu", timeout=0.5)


# ---------------------------------------------------------------------------
# launches: each starts its ranks once and runs several jobs
# ---------------------------------------------------------------------------

ON, OFF = _torch_cfg(_cfg(dropout=0.1)), _torch_cfg(_cfg(dropout=0.0))
TRAIN = _torch_cfg(_cfg(dropout=0.1, num_epochs=3, plateau_patience=0, plateau_factor=0.5,
                        save_interval_steps=1, keep_checkpoints=2))
RECS, VAL = tdp.synthetic_dataset(16, seed=2), tdp.synthetic_dataset(8, seed=3)
DATASET_RECS = jdp.synthetic_dataset(13, seed=8)  # 13 rows over 2 shards: one dropped
TRAIN_LAYOUTS = {"data2": (None, 2, 1), "model2": (None, 1, 2)}


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    """Two ranks: a step over (data 2) and over (model 2), ``run_training``
    over each, and the sharded device dataset."""
    _, batch, sd = inputs
    root = tmp_path_factory.mktemp("two_ranks")
    dirs = {k: (str(root / k / "ckpt"), str(root / k / "metrics.jsonl")) for k in TRAIN_LAYOUTS}
    for k in TRAIN_LAYOUTS:
        os.makedirs(root / k)
    todo = [("step", ((None, 2, 1), ON, sd, batch, 3), {}),
            ("step", ((None, 1, 2), ON, sd, batch, 3), {})]
    todo += [("training", (layout, TRAIN, RECS, VAL, sd, 8, 3, *dirs[k]), {})
             for k, layout in TRAIN_LAYOUTS.items()]
    todo.append(("sharded_dataset", ((None, 2, 1), ON.model, DATASET_RECS, 4, 1), {}))
    crash = {k: str(root / k / "crash") for k in TRAIN_LAYOUTS}
    todo += [("training_crash", (layout, TRAIN, RECS, sd, crash[k]), {})
             for k, layout in sorted(TRAIN_LAYOUTS.items())]
    out = launch("torch_parallel_ranks:jobs", 2, args=(todo,), device="cpu")
    return dict(out=out, dirs=dirs)


@pytest.fixture(scope="module")
def four_ranks(inputs):
    """Four ranks: a step over (data 4) and fan-out decoding over it."""
    _, batch, sd = inputs
    model = ranks._model(ON.model, sd).eval()
    enc = model.encode(ranks._rows(batch, slice(None)).inputs)
    mem, kpm = enc.memory.numpy(), enc.memory_key_padding_mask.numpy()
    todo = [("step", ((None, 4, 1), ON, sd, batch, 3), {}),
            ("fanout", ((None, 4, 1), ON.model, sd, mem, kpm, 3, 12, 4), {})]
    return dict(out=launch("torch_parallel_ranks:jobs", 4, args=(todo,), device="cpu"), enc=enc)


# ---------------------------------------------------------------------------
# the train step over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["data2", "model2", "data4"])
def test_step_over_ranks_matches_one_process(inputs, two_ranks, four_ranks, case):
    """Dropout on: every mask drawn at the global shape and sliced, so the
    ranks' step is the one-process step (loss, metrics, gradients)."""
    _, batch, sd = inputs
    m, grads, _ = _one_process_step(ON, sd, batch, seed=3)
    runs = {"data2": [o[0] for o in two_ranks["out"]], "model2": [o[1] for o in two_ranks["out"]],
            "data4": [o[0] for o in four_ranks["out"]]}[case]
    for o in runs:  # every rank reports the global batch's metrics
        assert abs(o["loss"] - float(m.loss)) <= LOSS_RTOL * float(m.loss)
        assert o["acc"] == pytest.approx(float(m.token_accuracy), abs=1e-6)
        assert o["gnorm"] == pytest.approx(float(m.grad_norm), rel=1e-5)
    _assert_step(runs[0], float(m.loss), grads)


def test_multislice_step_matches_one_process_and_jax_mesh(inputs):
    """8 ranks as (dcn 2, data 2, model 2): the mesh's layout and collectives
    (the two-stage sum equals the flat one within float32 rounding), and the
    step's gradients against one process with dropout on; the same ranks with
    dropout off against JAX's ``train_step`` on its (dcn, data, model) mesh."""
    params, batch, sd = inputs
    m, grads, _ = _one_process_step(ON, sd, batch, seed=5)
    todo = [("step", ((2, 2, 2), ON, sd, batch, 5), {}), ("step", ((2, 2, 2), OFF, sd, batch, 5), {}),
            ("mesh_facts", ((2, 2, 2),), {})]
    out = launch("torch_parallel_ranks:jobs", 8, args=(todo,), device="cpu")
    layout = tmesh.mesh_layout(8, 2, 2, 2)
    for r, (_, _, f) in enumerate(out):
        assert f["names"] == ("dcn", "data", "model") and f["shape"] == (2, 2, 2)
        assert tuple(np.argwhere(layout == r)[0]) == tuple(f["coord"])
        assert f["extent"] == 4 and f["rows"] == slice(2 * f["dp_index"], 2 * f["dp_index"] + 2)
        np.testing.assert_allclose(f["two_stage"], f["flat"], rtol=1e-6, atol=1e-5)
        assert f["gathered"] == list(range(8))
    _assert_step(out[0][0], float(m.loss), grads)

    # dropout off, against JAX over its virtual mesh
    cfg = _cfg(dropout=0.0)
    jmodel = jmmt.MultimodalTransformer(cfg.model)
    mesh = jpar.make_multislice_mesh(slices=2, data=2, model=2)
    p = jax.device_put(params, jpar.param_shardings(mesh, params, tensor_parallel=True))
    b = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), jpar.batch_sharding(mesh)), batch)
    rng = jax.random.PRNGKey(5)
    jgrads = jax.jit(lambda ps, bt: jax.grad(
        lambda q: jstep.loss_fn(q, jmodel, cfg, bt, rng)[0])(ps))(p, b)
    _, jm = jstep.train_step(jmodel, cfg, jcreate_state(cfg.train, p), b, rng)
    _assert_step(out[0][1], float(jm.loss),
                 {k: v.numpy() for k, v in tconvert.from_jax_params(jgrads).items()})


# ---------------------------------------------------------------------------
# run_training over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(TRAIN_LAYOUTS))
def test_run_training_over_ranks_matches_one_process(inputs, two_ranks, tmp_path, case):
    """Three steps over two epochs with validation, the plateau (patience 0)
    and a checkpoint every step, host batches split by rows: the losses
    (2e-5 relative), the validation loss, the plateau and the generation
    metrics of one process; rank 0 alone writes the log and the files; the
    checkpoint holds the whole parameters, which the JAX package reads."""
    params, _, sd = inputs
    ref = tloop.run_training(
        TRAIN, tdp.Loader(RECS, TRAIN.model, batch_size=8, seed=1),
        tdp.Loader(VAL, TRAIN.model, batch_size=8, seed=2),
        init_params={k: torch.from_numpy(v) for k, v in sd.items()}, max_steps=3,
        device_data=False, device="cpu", gen_metrics_every=2)
    job = 2 + sorted(TRAIN_LAYOUTS).index(case)
    out = [o[job] for o in two_ranks["out"]]
    ckpt, log = two_ranks["dirs"][case]
    for o in out:
        assert o["steps"] == ref.steps == 3
        assert len(o["history"]) == len(ref.metrics.history)
        for a, b in zip(o["history"], ref.metrics.history):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=LOSS_RTOL, abs=1e-6, nan_ok=True), k
        assert o["plateau"] == pytest.approx((float(ref.state.plateau.best),
                                              ref.state.plateau.bad_count,
                                              float(ref.state.plateau.scale)), rel=LOSS_RTOL)
    with open(log) as f:  # one writer: no line twice
        lines = [json.loads(x) for x in f]
    assert len(lines) == len(out[0]["history"])
    for a, b in zip(lines, out[0]["history"]):
        assert a == pytest.approx(b, nan_ok=True)
    assert sorted(os.listdir(ckpt)) == ["2.pt", "3.pt"]
    payload = torch.load(os.path.join(ckpt, "3.pt"), weights_only=True)
    full = out[0]["params"]
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == {
        k: v.shape for k, v in sd.items()}
    for k, v in payload["params"].items():
        np.testing.assert_array_equal(v.numpy(), full[k])
        # AdamW moves unresolved elements by about lr a step: 3 steps
        assert np.abs(full[k] - ref.state.model.state_dict()[k].numpy()).max() <= 3 * LR, k
    path = str(tmp_path / "params.msgpack")
    tckpt.export_params_msgpack(payload["params"], path)
    back = tconvert.from_jax_params(jckpt.import_params_msgpack(params, path))
    for k, v in payload["params"].items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


@pytest.mark.parametrize("case", sorted(TRAIN_LAYOUTS))
def test_run_training_crash_backup_over_ranks(two_ranks, case):
    """A step that raises at step 2 under each mesh: with whole parameters
    (data 2) rank 0 writes the crash backup beside the step-1 checkpoint;
    under tensor parallelism (model 2) it writes none and says so, and the
    other rank prints nothing of it."""
    out = [o[5 + sorted(TRAIN_LAYOUTS).index(case)] for o in two_ranks["out"]]
    for o in out:
        assert o["files"] == (["1.pt", "last_backup_params.msgpack"] if case == "data2"
                              else ["1.pt"])
    if case == "data2":
        assert "crash backup saved to" in out[0]["printed"]
    else:
        assert "no crash backup under tensor parallelism" in out[0]["printed"]
    assert "crash backup" not in out[1]["printed"]


# ---------------------------------------------------------------------------
# the sharded device dataset and sharded fan-out decoding
# ---------------------------------------------------------------------------

def test_sharded_device_dataset_matches_jax(two_ranks):
    """Each rank's partition, and its gathered rows of every batch, equal what
    JAX's sharded dataset and ``sharded_gather_fn`` give those rows."""
    jl = jdp.Loader(DATASET_RECS, MCFG, batch_size=4, seed=1)
    jmesh = jpar.make_mesh(data=2, model=4)
    jdd = jl.device_dataset_sharded(jmesh)
    gather = jdp.sharded_gather_fn(jmesh)
    jidx = list(jl.epoch_row_batches_sharded(1, 2))
    for r, o in enumerate(o[4] for o in two_ranks["out"]):
        assert o["kept"] == jl._device_kept_smiles
        np.testing.assert_array_equal(o["part_trg"], np.asarray(jdd.trg_tokens)[6 * r : 6 * r + 6])
        assert len(o["idx"]) == len(jidx) == 3
        for k, (a, b) in enumerate(zip(o["idx"], jidx)):
            np.testing.assert_array_equal(a, np.asarray(b))
            jb = gather(jdd, jax.device_put(jnp.asarray(b), jpar.batch_sharding(jmesh)))
            np.testing.assert_array_equal(o["trg"][k], np.asarray(jb.trg_tokens)[2 * r : 2 * r + 2])
            np.testing.assert_array_equal(o["src_1h"][k],
                                          np.asarray(jb.inputs.src_1h)[2 * r : 2 * r + 2])


def test_sharded_fanout_decoding_matches_one_process(inputs, four_ranks):
    """Four ranks decode their molecules' lanes with the global Gumbel rows:
    the tokens of one process's fan-out and greedy decodes."""
    from multimodalspectraltransformer_torch.decode import samplers

    _, _, sd = inputs
    model = ranks._model(ON.model, sd).eval()
    enc = four_ranks["enc"]
    ref = samplers.multinomial_decode(model.state_dict(), ON.model, enc.memory,
                                      enc.memory_key_padding_mask,
                                      torch.Generator().manual_seed(3), 1.0, 12, fanout=4,
                                      device="cpu")
    greedy = samplers.greedy_decode(model.state_dict(), ON.model, enc.memory,
                                    enc.memory_key_padding_mask, 1.0, 12, device="cpu")
    for o in four_ranks["out"]:
        np.testing.assert_array_equal(o[1]["mn"], ref.tokens.numpy())
        np.testing.assert_array_equal(o[1]["greedy"], greedy.tokens.numpy())
