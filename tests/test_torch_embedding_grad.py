"""Kernel E1's plain version and the lookup that trains every table, on the CPU.

``ops/embedding_grad.py`` against PyTorch's ``F.embedding`` backward and the
JAX package's lookup (flax's ``nn.Embed``, whose gradient XLA computes as a
scatter-add), on the same numpy inputs. Tolerances:

- float32: every element within 1e-6 of its table row's largest magnitude
  (the sums are taken in other orders);
- bfloat16 gradients: the plain version sums in float32 and rounds once, so
  it equals the float32 sum of the same values rounded to bfloat16 within
  one bfloat16 unit (2^-8 relative) of each element;
- a table row that no id reaches: exactly zero.

Then an autograd-graph scan of one small train step of the MMT, the CLIP
tower and the BLIP tower (and the Q-Former's LM surface): every trained table
is read through ``embedding_lookup``, and no backward whose sum order may
vary on the card (``EmbeddingBackward0``, or an index or gather backward)
accumulates into a parameter or into a cast of one.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.ops import embedding_grad as e1
from multimodalspectraltransformer_torch.rank import clip as tc
from multimodalspectraltransformer_torch.rank import qformer as tq
from multimodalspectraltransformer_torch.train import contrastive as tcon
from multimodalspectraltransformer_torch.train import step as tstep
from multimodalspectraltransformer_torch.utils import config as tconfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (V, D, ids shape, how the ids are drawn): the trained tables' shapes cut
# down, and the draws that stress the sum
CASES = {
    "uniform": (43, 16, (8, 63), "uniform"),
    "heavy": (213, 8, (16, 64), "heavy"),  # 90% one id, as MF's padding
    "edges": (128, 12, (4, 33), "edges"),  # ids 0 and V-1 only
    "position": (130, 24, (6, 20), "position"),  # Roberta positions: a run per column
    "one_row": (5, 4, (1,), "uniform"),
}


def _inputs(case: str, seed: int = 0):
    V, D, shape, kind = CASES[case]
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        ids = rng.integers(0, V, shape)
    elif kind == "heavy":
        ids = np.where(rng.random(shape) < 0.9, 0, rng.integers(0, V, shape))
    elif kind == "edges":
        ids = np.where(rng.random(shape) < 0.5, 0, V - 1)
    else:
        ids = np.broadcast_to(np.arange(shape[1]) + 2, shape).copy()
        ids[:, shape[1] // 2:][rng.random((shape[0], shape[1] - shape[1] // 2)) < 0.5] = 1
    grad = rng.normal(size=(*shape, D)).astype(np.float32)
    weight = rng.normal(size=(V, D)).astype(np.float32)
    return V, ids.astype(np.int64), grad, weight


def _close_per_row(got: np.ndarray, want: np.ndarray, rtol: float) -> None:
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    assert np.all(np.abs(got - want) <= rtol * scale), float(np.max(np.abs(got - want) / scale))


def _f_embedding_grad(weight: np.ndarray, ids: np.ndarray, grad: np.ndarray) -> np.ndarray:
    w = torch.from_numpy(weight).requires_grad_()
    F.embedding(torch.from_numpy(ids), w).backward(torch.from_numpy(grad))
    return w.grad.numpy()


def _jax_grad(weight: np.ndarray, ids: np.ndarray, grad: np.ndarray) -> np.ndarray:
    embed = fnn.Embed(weight.shape[0], weight.shape[1])
    fn = lambda w: jnp.sum(embed.apply({"params": {"embedding": w}}, jnp.asarray(ids, jnp.int32))
                           * jnp.asarray(grad))
    return np.asarray(jax.grad(fn)(jnp.asarray(weight)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_and_lookup_gradient_equal_torch_and_jax(case):
    V, ids, grad, weight = _inputs(case)
    plain = e1.embedding_grad_plain(torch.from_numpy(grad), torch.from_numpy(ids), V).numpy()
    w = torch.from_numpy(weight).requires_grad_()
    out = e1.embedding_lookup(w, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), weight[ids])  # the forward is the gather
    out.backward(torch.from_numpy(grad))
    ref = _f_embedding_grad(weight, ids, grad)
    for got in (plain, w.grad.numpy(), _jax_grad(weight, ids, grad)):
        assert got.dtype == np.float32 and got.shape == (V, weight.shape[1])
        _close_per_row(got, ref, 1e-6)
    unseen = np.setdiff1d(np.arange(V), ids)
    assert np.all(plain[unseen] == 0.0) and np.all(w.grad.numpy()[unseen] == 0.0)
    if case == "edges":
        assert len(unseen) == V - 2


def test_plain_version_sums_a_float64_gradient_in_float64():
    """The card's checks hold E1 to the plain version of the float64 upcast
    of its input: that sum is float64 throughout, not float32."""
    V, ids, grad, _ = _inputs("heavy")
    g64 = torch.from_numpy(grad).double() * (1 + 1e-12)
    got = e1.embedding_grad_plain(g64, torch.from_numpy(ids), V)
    want = np.zeros((V, grad.shape[-1]))
    np.add.at(want, ids.reshape(-1), g64.numpy().reshape(-1, grad.shape[-1]))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("case", ["uniform", "heavy", "position"])
def test_bf16_gradient_is_the_float32_sum_rounded_once(case):
    """A bfloat16 gradient through a bfloat16 cast of a float32 table (the
    trainer's mixed precision): the table's gradient is the float32 sum of the
    bfloat16 rows, rounded once to bfloat16."""
    V, ids, grad, weight = _inputs(case, seed=1)
    g16 = torch.from_numpy(grad).bfloat16()
    plain = e1.embedding_grad_plain(g16, torch.from_numpy(ids), V)
    assert plain.dtype == torch.bfloat16
    w = torch.from_numpy(weight).requires_grad_()
    e1.embedding_lookup(w.bfloat16(), torch.from_numpy(ids)).backward(g16)
    assert w.grad.dtype == torch.float32
    exact = _f_embedding_grad(weight, ids, g16.float().numpy())
    for got in (plain.float().numpy(), w.grad.numpy()):
        assert np.all(np.abs(got - exact) <= 2.0**-8 * np.abs(exact))
    np.testing.assert_array_equal(plain.float().numpy(), w.grad.numpy())


def test_embedding_grad_takes_the_plain_version_only_on_cpu():
    """On the CPU the plain version runs and no launch is counted; on another
    device type it raises instead of falling back."""
    e1.reset_launches()
    V, ids, grad, _ = _inputs("uniform")
    got = e1.embedding_grad(torch.from_numpy(grad), torch.from_numpy(ids), V)
    torch.testing.assert_close(got, e1.embedding_grad_plain(torch.from_numpy(grad),
                                                            torch.from_numpy(ids), V),
                               rtol=0, atol=0)
    assert e1.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        e1.embedding_grad(torch.from_numpy(grad).to("meta"), torch.from_numpy(ids).to("meta"), V)


@pytest.mark.parametrize("bad", ["grad_dtype", "ids_dtype", "shape", "empty"])
def test_embedding_grad_checks_its_inputs(bad):
    V, ids, grad, _ = _inputs("uniform")
    g, i = torch.from_numpy(grad), torch.from_numpy(ids)
    if bad == "grad_dtype":
        g = g.half()
    elif bad == "ids_dtype":
        i = i.int()
    elif bad == "shape":
        g = g[:, :-1]
    else:
        V = 0
    with pytest.raises((ValueError, TypeError)):
        e1.embedding_grad(g, i, V)


# ---------------------------------------------------------------------------
# no order-dependent lookup backward on the trainers' graphs
# ---------------------------------------------------------------------------

ORDER_DEPENDENT = {"EmbeddingBackward0", "EmbeddingDenseBackward0", "IndexBackward0",
                   "IndexSelectBackward0", "GatherBackward0", "TakeBackward0",
                   "IndexPutBackward0", "EmbeddingBagBackward0"}


def _reaches_parameter(fn) -> bool:
    """Whether ``fn``'s inputs are a parameter or a dtype cast of one."""
    for nxt, _ in fn.next_functions:
        if nxt is None:
            continue
        if nxt.name() == "torch::autograd::AccumulateGrad":
            return True
        if nxt.name() == "ToCopyBackward0" and _reaches_parameter(nxt):
            return True
    return False


def _scan(loss: torch.Tensor) -> tuple[int, list[str]]:
    """(number of ``embedding_lookup`` backwards, the order-dependent
    backwards that accumulate into a parameter or its cast) of ``loss``'s
    graph."""
    seen, stack, lookups, bad = set(), [loss.grad_fn], 0, []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        lookups += fn.name() == "EmbeddingLookupBackward"
        if fn.name() in ORDER_DEPENDENT and _reaches_parameter(fn):
            bad.append(fn.name())
        stack.extend(n for n, _ in fn.next_functions)
    return lookups, bad


def _mmt_loss(ms: bool, mixed: bool) -> torch.Tensor:
    mods = tconfig.ModalityConfig(use_ms=ms)
    mcfg = tconfig.ModelConfig(hidden_size=32, num_heads=4, cross_num_heads=4,
                               num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64,
                               modalities=mods)
    cfg = tconfig.MMTConfig(model=mcfg, train=tconfig.TrainConfig(mixed_precision=mixed))
    model = tmmt.init_model(mcfg, seed=0, device="cpu")
    model.train()
    recs = tdp.synthetic_dataset(2, seed=0)
    batch = tdp.to_device(tdp.collate([tdp.featurize(r, mcfg) for r in recs]), "cpu")
    total, _ = tstep.loss_fn(model, cfg, batch, tstep.step_generator(0, 0))
    return total


def _tower_loss(tower: str) -> torch.Tensor:
    rng = np.random.default_rng(0)
    if tower == "clip":
        tcfg = tc.CLIPConfig(text_layers=1, text_heads=2, cb_embedding=32, text_hidden=32,
                             text_ffn=64, projection_dim=16, dropout=0.1)
    else:
        tcfg = tq.QFormerConfig(hidden=32, num_heads=2, ffn_dim=64, num_layers=2, num_queries=4,
                                encoder_width=32, projection_dim=16, dropout=0.1)
    model, *_ = tcon.make_tower(tower, tcfg)
    B, S, T = 4, 10, 16
    fp = torch.from_numpy(rng.normal(size=(B, 512)).astype(np.float32))
    memory = torch.from_numpy(rng.normal(size=(B, S, 128)).astype(np.float32))
    kpm = torch.zeros(B, S, dtype=torch.bool)
    toks = torch.from_numpy(rng.integers(4, 43, (B, T)))
    mask = torch.ones(B, T, dtype=torch.int64)
    mask[2, 9:] = 0
    model.train()
    return tcon.tower_loss(model, tower, (fp, memory, kpm), toks, mask, 1.0,
                           torch.Generator().manual_seed(0))


def _blip_lm_loss() -> torch.Tensor:
    """The Q-Former's LM surface, which reads its own word table."""
    rng = np.random.default_rng(0)
    qcfg = tq.QFormerConfig(hidden=32, num_heads=2, ffn_dim=64, num_layers=2, num_queries=4,
                            encoder_width=32, projection_dim=16)
    model, *_ = tcon.make_tower("blip", qcfg)
    B, S, T = 4, 10, 16
    memory = torch.from_numpy(rng.normal(size=(B, S, 128)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(4, 43, (B, T)))
    pad = torch.zeros(B, T, dtype=torch.int64)
    logits = model.lm_logits(toks, pad, memory, None)
    return tq.lm_loss(logits, toks, pad)


# (how the loss is built, the embedding_lookup backwards expected)
GRAPHS = {
    "mmt_fp32": (lambda: _mmt_loss(False, False), 3),  # MF, target tokens, positions
    "mmt_bf16": (lambda: _mmt_loss(False, True), 3),
    "mmt_ms_hint": (lambda: _mmt_loss(True, True), 4),  # and MS
    "clip": (lambda: _tower_loss("clip"), 2),  # word, positions
    "blip": (lambda: _tower_loss("blip"), 2),  # the text tower's word and positions
    "blip_lm": (_blip_lm_loss, 1),  # the Q-Former's word table
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_train_graphs_have_no_order_dependent_lookup_backward(graph):
    make, n_lookups = GRAPHS[graph]
    loss = make()
    lookups, bad = _scan(loss)
    assert bad == [], bad
    assert lookups == n_lookups
    loss.backward()  # the graph runs, through the plain version on the CPU


def test_scan_finds_the_lookup_it_guards_against():
    """The scan is not vacuous: ``F.embedding`` and indexing a cast table,
    the two forms the trainers used, are flagged."""
    w = torch.nn.Parameter(torch.randn(7, 4))
    ids = torch.tensor([1, 2, 2])
    assert _scan(F.embedding(ids, w).sum()) == (0, ["EmbeddingBackward0"])
    assert _scan(w.bfloat16()[ids].float().sum()) == (0, ["IndexBackward0"])
    assert _scan(e1.embedding_lookup(w.bfloat16(), ids).float().sum()) == (1, [])
