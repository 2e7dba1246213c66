"""The port's simulator trainer against the JAX package's ``sim/distill.py``.

The same teacher data (from a seeded corpus) and the same initial tree (the
JAX init, converted with ``convert.linear_params``) go through both
trainers at a small width: the final loss within 1e-5 relative, every
parameter within 1e-5 of its leaf's largest magnitude, the report's MAEs
within 1e-5 relative. The weight files are byte-equal to flax's and read by
the JAX package's loaders."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.sim import distill as tdistill
from multimodalspectraltransformer_torch.sim import gnn as tgnn
from multimodalspectraltransformer_tpu.data import molrandom
from multimodalspectraltransformer_tpu.sim import distill as jdistill
from multimodalspectraltransformer_tpu.sim import gnn as jgnn
from multimodalspectraltransformer_tpu.sim.graphs import BOND_TYPES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(hidden=16, steps=2)
_CACHE: dict = {}


def _data():
    if "data" not in _CACHE:
        _CACHE["data"] = jdistill.build_teacher_dataset(molrandom.random_corpus(64, seed=5))
    return _CACHE["data"]


def _jax_init(model, data, seed: int = 0):
    """The tree JAX's trainers start from at ``seed``."""
    dense = jdistill.densify_batch(*(jnp.asarray(data[k][:2]) for k in ("nodes", "edges", "n_atoms")))
    return jax.jit(model.init)(jax.random.PRNGKey(seed), *dense)["params"]


def _torch_sd(tree) -> dict:
    return tconvert.linear_params(jax.tree.map(np.asarray, tree))


def _assert_params_close(sd: dict, tree) -> None:
    for k, ref in _torch_sd(tree).items():
        ours = sd[k].detach().cpu()
        err = (ours - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (k, err)


def test_build_teacher_dataset_matches_jax():
    smiles = molrandom.random_corpus(64, seed=5) + ["not a smiles", "C" * 70]
    ref = jdistill.build_teacher_dataset(smiles)
    ours = tdistill.build_teacher_dataset(smiles)
    assert set(ours) == set(ref) and ours["smiles"] == ref["smiles"]
    assert len(ours["smiles"]) == 64  # the unparsable and the oversized one dropped
    for k, v in ref.items():
        if k != "smiles":
            assert ours[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_train_shift_model_matches_jax():
    data = _data()
    init = _jax_init(jgnn.NMRShiftModel(**SMALL), data)
    kw = dict(**SMALL, batch_size=8, n_steps=3, log_every=0)
    jparams, jstats, jrep = jdistill.train_shift_model(data, init_params=init, **kw)
    model, stats, rep = tdistill.train_shift_model(data, init_params=_torch_sd(init),
                                                   device="cpu", **kw)
    assert stats == jstats
    assert set(rep) == set(jrep)
    for k, v in jrep.items():
        if isinstance(v, float):
            assert rep[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert rep[k] == v, k
    _assert_params_close(model.state_dict(), jparams)


def test_train_ir_model_matches_jax():
    data = _data()
    jparams, jrep = jdistill.train_ir_model(data, bins=1801, batch_size=8, n_steps=3,
                                            log_every=0, seed=3, **SMALL)
    init = _jax_init(jgnn.IRModel(**SMALL, bins=1801), data, seed=3)
    model, rep = tdistill.train_ir_model(data, bins=1801, batch_size=8, n_steps=3, log_every=0,
                                         seed=3, init_params=_torch_sd(init), device="cpu",
                                         **SMALL)
    assert set(rep) == set(jrep)
    for k, v in jrep.items():
        if isinstance(v, float):
            assert rep[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert rep[k] == v, k
    _assert_params_close(model.state_dict(), jparams)


def test_training_logs_the_jax_lines(capsys):
    data = _data()
    init = _jax_init(jgnn.NMRShiftModel(**SMALL), data)
    kw = dict(**SMALL, batch_size=8, n_steps=2, log_every=1)
    jdistill.train_shift_model(data, init_params=init, **kw)
    ref = capsys.readouterr().out
    tdistill.train_shift_model(data, init_params=_torch_sd(init), device="cpu", **kw)
    ours = capsys.readouterr().out
    assert ours.splitlines() == ref.splitlines() and len(ours.splitlines()) == 2


@pytest.mark.parametrize("kind", ["shift", "ir"])
def test_zero_learning_rate_leaves_the_parameters(kind):
    data = _data()
    if kind == "shift":
        init = _torch_sd(_jax_init(jgnn.NMRShiftModel(**SMALL), data))
        model = tdistill.train_shift_model(data, init_params=init, batch_size=8, n_steps=2,
                                           lr=0.0, log_every=0, device="cpu", **SMALL)[0]
    else:
        init = _torch_sd(_jax_init(jgnn.IRModel(**SMALL, bins=1801), data))
        model = tdistill.train_ir_model(data, init_params=init, bins=1801, batch_size=8, n_steps=2,
                                        lr=0.0, log_every=0, device="cpu", **SMALL)[0]
    for k, v in model.state_dict().items():
        assert torch.equal(v, init[k]), k


def test_fresh_init_is_seeded_and_flax_shaped():
    """Without ``init_params`` the port draws flax's initializer from its own
    generator: the same seed gives the same weights, of the JAX tree's
    shapes, zero biases."""
    data = _data()
    kw = dict(**SMALL, batch_size=8, n_steps=1, lr=0.0, log_every=0, device="cpu")
    a = tdistill.train_shift_model(data, seed=4, **kw)[0].state_dict()
    b = tdistill.train_shift_model(data, seed=4, **kw)[0].state_dict()
    ref = _torch_sd(_jax_init(jgnn.NMRShiftModel(**SMALL), data))
    assert set(a) == set(ref)
    for k, v in a.items():
        assert torch.equal(v, b[k]) and v.shape == ref[k].shape, k
        if k.endswith("bias"):
            assert not v.any(), k


@pytest.mark.parametrize("trainer", ["shift", "ir"])
def test_zero_steps_raise_as_optax_does(trainer):
    fn = tdistill.train_shift_model if trainer == "shift" else tdistill.train_ir_model
    with pytest.raises(ValueError, match="positive decay_steps"):
        fn(_data(), n_steps=0, device="cpu", **SMALL)


def test_cosine_decay_lr_is_optax_schedule():
    import optax

    sched = optax.cosine_decay_schedule(2e-3, 7, 0.05)
    for k in range(10):
        assert tdistill.cosine_decay_lr(2e-3, 7, k) == pytest.approx(float(sched(k)), rel=1e-6)


def test_saved_files_are_flax_bytes_and_the_jax_loaders_read_them(tmp_path):
    data = _data()
    init = _jax_init(jgnn.NMRShiftModel(**SMALL), data)
    kw = dict(**SMALL, batch_size=8, n_steps=2, log_every=0)
    jparams, stats, rep = jdistill.train_shift_model(data, init_params=init, **kw)
    jir, irep = jdistill.train_ir_model(data, bins=1801, batch_size=8, n_steps=2, log_every=0,
                                        **SMALL)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jdistill.save_shift_weights(jparams, stats, rep, out_dir=jdir)
    jdistill.save_ir_weights(jir, irep, out_dir=jdir)
    shift = tgnn.NMRShiftModel(**SMALL)
    shift.load_state_dict(_torch_sd(jparams))
    ir = tgnn.IRModel(**SMALL, bins=1801)
    ir.load_state_dict(_torch_sd(jir))
    tdistill.save_shift_weights(shift, stats, rep, tdir)
    tdistill.save_ir_weights(ir, irep, tdir)
    for name in ("nmr_shift.msgpack", "nmr_shift.json", "ir.msgpack", "ir.json"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jp, _, jst = jdistill.load_shift_weights(tdir)
    assert (jst.mean_c, jst.std_c) == (stats["mean_c"], stats["std_c"])
    _assert_params_close(shift.state_dict(), jp)
    jp_ir, _ = jdistill.load_ir_weights(tdir)
    _assert_params_close(ir.state_dict(), jp_ir)
    tmodel, tstats = tdistill.load_shift_weights(tdir, device="cpu")
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, shift.state_dict()[k]), k


def test_committed_weights_round_trip_byte_for_byte(tmp_path):
    """The committed simulator weights, loaded by the port and saved again,
    are the committed files byte for byte."""
    model, stats = tdistill.load_shift_weights(device="cpu")
    ir = tdistill.load_ir_weights(device="cpu")
    with open(os.path.join(tdistill.WEIGHTS_DIR, "nmr_shift.json")) as f:
        meta = json.load(f)
    tdistill.save_shift_weights(model, meta["stats"], meta["report"], str(tmp_path))
    tdistill.save_ir_weights(ir, {}, str(tmp_path))
    for name in ("nmr_shift.msgpack", "nmr_shift.json", "ir.msgpack"):
        with open(os.path.join(tdistill.WEIGHTS_DIR, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read(), name


def _densify_with_nonzero(nodes_i8, edges_i8, n_atoms, max_nodes=64):
    """The port's densify before it became sync-free (``torch.nonzero`` of
    the valid edges, an ``index_put_`` of ones): the reference for it."""
    nodes = nodes_i8.float()
    mask = (torch.arange(max_nodes)[None, :] < n_atoms[:, None]).float()
    e = edges_i8.long()
    b_idx, e_idx = torch.nonzero(e[..., 2] >= 0, as_tuple=True)
    a1, a2, t = e[b_idx, e_idx, 0], e[b_idx, e_idx, 1], e[b_idx, e_idx, 2]
    adj = torch.zeros(nodes.shape[0], BOND_TYPES, max_nodes, max_nodes)
    adj.index_put_((b_idx, t, a1, a2), torch.ones_like(a1, dtype=torch.float32), accumulate=True)
    return nodes, adj + adj.transpose(2, 3), mask


def test_sync_free_densify_equals_the_nonzero_version():
    data = _data()
    nodes, edges, n_at = (torch.from_numpy(data[k][:32]) for k in ("nodes", "edges", "n_atoms"))
    # every bond type, repeated edges and self loops, a graph with no edge at all
    rng = np.random.default_rng(0)
    extra = edges.clone()
    extra[0, :40] = torch.from_numpy(np.stack([rng.integers(0, 64, 40), rng.integers(0, 64, 40),
                                               rng.integers(0, BOND_TYPES, 40)], 1).astype(np.int8))
    extra[1, :4] = torch.tensor([[3, 3, 2], [3, 3, 2], [5, 5, 0], [1, 2, 3]], dtype=torch.int8)
    extra[2] = -1
    for e in (edges, extra):
        for a, b in zip(_densify_with_nonzero(nodes, e, n_at), tdistill.densify_batch(nodes, e, n_at)):
            assert torch.equal(a, b)
