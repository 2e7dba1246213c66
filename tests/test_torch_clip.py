"""The port's CLIP ranking tower against the JAX package's ``rank/clip.py``.

The same numpy inputs go through both packages on the CPU (JAX at
``highest`` matmul precision, the suite's setting).

Tolerances:

- float32: within 1e-5 * max(1, |x|) of the JAX function (embeddings,
  losses, dot similarities, logits); float32 sums in another order.
- ``compute_dtype="bfloat16"``: within 1e-5 * max(1, |x|) of the JAX
  function run op by op (``jax.disable_jit``), where every rounding to
  bfloat16 happens where the flax modules' dtypes put it. Against the
  compiled JAX function, within 2^-7 * max|cb| * max|mt| (the embeddings'
  largest norms, float32) for losses, dots and logits alike: XLA's fusions
  drop some of those roundings (the embedding sum before its LayerNorm,
  GELU's argument), so the compiled and the op-by-op JAX results differ. A
  relative change of 2^-8 (one bfloat16 unit) in each element of an
  embedding moves a logit cb . mt by at most 2^-8 * |cb| * |mt|, and a loss
  by about as much as its logits move; two units are allowed. The measured
  gap is recorded as the JUnit property ``max_abs_diff_vs_compiled``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.models.convert import from_jax_clip_params
from multimodalspectraltransformer_torch.rank import clip as tc
from multimodalspectraltransformer_torch.train.contrastive import clip_tokenize
from multimodalspectraltransformer_tpu.data import molrandom
from multimodalspectraltransformer_tpu.rank import clip as jc
from multimodalspectraltransformer_tpu.train import contrastive as jcontrastive


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_R4 = os.path.join(REPO, "weights", "clip_r4.msgpack.gz")
SMALL = dict(text_vocab_size=600, text_hidden=64, text_layers=2, text_heads=4, text_ffn=128,
             text_max_len=32, cb_embedding=96, mt_embedding=48, projection_dim=40)
F32_RTOL = 1e-5
BF16_RTOL = 2.0**-7

_CACHE: dict = {}


def _close(ours, theirs, rtol: float, scale=None) -> None:
    """|ours - theirs| <= rtol * max(1, |theirs|) elementwise, or with
    ``scale`` <= rtol * max(1, scale)."""
    a = np.asarray(ours, np.float64)
    b = np.asarray(theirs, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    bound = rtol * np.maximum(1.0, np.abs(b) if scale is None else scale)
    worst = np.max(np.abs(a - b) - bound)
    assert worst <= 0.0, f"off by {np.max(np.abs(a - b)):.3e} (rtol {rtol})"


def _small():
    """A random-init JAX CLIPRanker at a small width, every variable moved
    off its init (zero biases, unit scales) by seeded noise, and the port's
    model with the converted weights."""
    if "small" not in _CACHE:
        jcfg = jc.CLIPConfig(**SMALL)
        rng = np.random.default_rng(0)
        toks, mask = clip_tokenize(["CCO"], jcfg.text_max_len)
        v = jc.CLIPRanker(jcfg).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.asarray(toks), jnp.asarray(mask), jnp.zeros((1, jcfg.mt_embedding)), True)
        v = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype), v)
        model = tc.CLIPRanker(tc.CLIPConfig(**SMALL))
        model.load_state_dict(from_jax_clip_params(jax.tree.map(np.asarray, v)))
        _CACHE["small"] = (v, jcfg, model.eval(), tc.CLIPConfig(**SMALL))
    return _CACHE["small"]


def _clip_r4():
    if "r4" not in _CACHE:
        jv, jcfg = jc.load_bundle(CLIP_R4)
        model, tcfg = tc.load_bundle(CLIP_R4, device="cpu")
        _CACHE["r4"] = (jv, jcfg, model, tcfg)
    return _CACHE["r4"]


def _blocks(m: int, c: int, max_len: int, seed: int):
    smis = molrandom.random_corpus(m * c, seed=seed)
    toks, mask = clip_tokenize(smis, max_len)
    return toks.reshape(m, c, max_len), mask.reshape(m, c, max_len)


def _embedding_scale(model, toks, mask, fps) -> float:
    """max |cb| * max |mt| over the block's float32 embeddings."""
    with torch.no_grad():
        cb = model.embed_text(torch.from_numpy(toks.reshape(-1, toks.shape[-1])),
                              torch.from_numpy(mask.reshape(-1, mask.shape[-1])))
        mt = model.embed_spectrum(torch.from_numpy(fps))
    return float(cb.norm(dim=-1).max() * mt.norm(dim=-1).max())


def _check_bf16(ours, theirs, jv, jcfg, model, toks, mask, fps, record_property) -> None:
    """The bfloat16 scores against the op-by-op and the compiled JAX function
    (the module docstring's tolerances)."""
    with jax.disable_jit():
        op_by_op = jc.score_candidates_batch(jv, jcfg, jnp.asarray(toks), jnp.asarray(mask),
                                             jnp.asarray(fps), compute_dtype="bfloat16")
    scale = _embedding_scale(model, toks, mask, fps)
    gap = 0.0
    for a, b, c in zip(ours, op_by_op, theirs):
        _close(a, b, F32_RTOL)
        _close(a, c, BF16_RTOL, scale=scale)
        gap = max(gap, float(np.abs(a.numpy() - np.asarray(c)).max()))
    record_property("max_abs_diff_vs_compiled", gap)
    record_property("embedding_norm_product", scale)


def _both_batches(jv, jcfg, model, tcfg, toks, mask, fps, compute_dtype):
    theirs = jc.score_candidates_batch(jv, jcfg, jnp.asarray(toks), jnp.asarray(mask),
                                       jnp.asarray(fps), compute_dtype=compute_dtype)
    ours = tc.score_candidates_batch(model, tcfg, torch.from_numpy(toks), torch.from_numpy(mask),
                                     torch.from_numpy(fps), compute_dtype=compute_dtype)
    return ours, theirs


def test_clip_tokenize_is_the_jax_function():
    smis = ["CCO", "c1ccccc1O", "", "C" * 200, "CC(=O)N[C@@H](C)C(=O)O"]
    for max_len in (16, 64, 128):
        ours = clip_tokenize(smis, max_len)
        theirs = jcontrastive.clip_tokenize(smis, max_len)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_clip_config_is_the_jax_config():
    import dataclasses

    assert dataclasses.asdict(tc.CLIPConfig()) == dataclasses.asdict(jc.CLIPConfig())


def test_embeddings_and_loss_match_jax_at_small_width():
    v, jcfg, model, _ = _small()
    toks, mask = _blocks(1, 6, jcfg.text_max_len, seed=3)
    toks, mask = toks[0], mask[0]
    fps = np.random.default_rng(1).normal(size=(6, jcfg.mt_embedding)).astype(np.float32)
    jm = jc.CLIPRanker(jcfg)
    cb_j = jm.apply(v, jnp.asarray(toks), jnp.asarray(mask), True, method="embed_text")
    mt_j = jm.apply(v, jnp.asarray(fps), True, method="embed_spectrum")
    with torch.no_grad():
        cb_t = model.embed_text(torch.from_numpy(toks), torch.from_numpy(mask))
        mt_t = model.embed_spectrum(torch.from_numpy(fps))
    _close(cb_t, cb_j, F32_RTOL)
    _close(mt_t, mt_j, F32_RTOL)
    loss_j = jc.clip_loss(cb_j, mt_j, 0.7)
    loss_t = tc.clip_loss(cb_t, mt_t, 0.7)
    for a, b in zip(loss_t, loss_j):
        _close(a, b, F32_RTOL)
    score_j = jc.score_candidates(v, jcfg, jnp.asarray(toks), jnp.asarray(mask), jnp.asarray(fps[0]))
    score_t = tc.score_candidates(model, model.cfg, torch.from_numpy(toks), torch.from_numpy(mask),
                                  torch.from_numpy(fps[0]))
    for a, b in zip(score_t, score_j):
        _close(a, b, F32_RTOL)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_score_candidates_batch_matches_jax_at_small_width(compute_dtype, record_property):
    v, jcfg, model, tcfg = _small()
    toks, mask = _blocks(3, 5, jcfg.text_max_len, seed=4)
    fps = np.random.default_rng(2).normal(size=(3, jcfg.mt_embedding)).astype(np.float32)
    ours, theirs = _both_batches(v, jcfg, model, tcfg, toks, mask, fps, compute_dtype)
    assert ours.losses.shape == (3, 5) and ours.logits.shape == (3, 5, 5)
    assert ours.losses.dtype == torch.float32
    if compute_dtype is None:
        for a, b in zip(ours, theirs):
            _close(a, b, F32_RTOL)
        return
    _check_bf16(ours, theirs, v, jcfg, model, toks, mask, fps, record_property)
    # bfloat16 really changes the result: it is not the float32 function
    f32, _ = _both_batches(v, jcfg, model, tcfg, toks, mask, fps, None)
    assert not torch.equal(f32.losses, ours.losses)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_score_candidates_batch_matches_jax_with_clip_r4(compute_dtype, record_property):
    """The trained tower at full width (6 layers, 768 wide, text length 128),
    both packages loading the committed bundle, on 2 molecules x 10
    candidates with fingerprints of the MMT's scale."""
    jv, jcfg, model, tcfg = _clip_r4()
    assert model.cfg == tcfg and tcfg.text_hidden == 768 and tcfg.text_layers == 6
    toks, mask = _blocks(2, 10, tcfg.text_max_len, seed=5)
    fps = np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32)
    ours, theirs = _both_batches(jv, jcfg, model, tcfg, toks, mask, fps, compute_dtype)
    assert all(bool(torch.isfinite(x).all()) for x in ours)
    if compute_dtype is None:
        for a, b in zip(ours, theirs):
            _close(a, b, F32_RTOL)
        return
    _check_bf16(ours, theirs, jv, jcfg, model, toks, mask, fps, record_property)


def test_load_bundle_reads_the_committed_tower():
    """The port's reader gives the flax tree's float32 leaves, and the state
    dict covers every parameter of the port's model."""
    from multimodalspectraltransformer_torch.models.convert import read_msgpack

    tree = read_msgpack(CLIP_R4)
    sd = from_jax_clip_params(tree)
    model = tc.CLIPRanker(tc.CLIPConfig())
    assert set(sd) == set(model.state_dict())
    n_params = sum(t.numel() for t in sd.values())
    assert 45_000_000 < n_params < 46_000_000
    p = tree["params"]["text_encoder"]
    assert p["token_type_embedding"].shape == (768,)
    assert p["position_embeddings"]["embedding"].shape == (130, 768)
    np.testing.assert_array_equal(
        sd["text_encoder.encoder.layers.3.linear1.weight"].numpy(),
        p["encoder"]["layers_3"]["linear1"]["kernel"].T)
