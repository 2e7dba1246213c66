"""KV-cached decoding of the port against the JAX package: kernel K1's plain
version, the decoder step, greedy decoding and multinomial sampling.

Greedy and sampled decodes must be token-identical; sampling gets the JAX
gumbel draws (``jax.random.gumbel(fold_in(rng, t), ...)``, which is what
``jax.random.categorical`` adds) through the port's ``noise`` argument."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.decode import functional as tf
from multimodalspectraltransformer_torch.decode import samplers as ts
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.ops import decode_attention as tk1
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.decode import functional as jf
from multimodalspectraltransformer_tpu.decode import samplers as js
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.ops import decode_attention as jk1
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
SMALL = ModelConfig(num_encoder_layers=1, num_decoder_layers=2, ffn_dim=256, max_len=24)

_CACHE: dict = {}


def _setup(name: str):
    """(cfg, JAX params, port state dict, memory, kpm) for 'small' (random
    init) or 'phase3' (committed weights, full width)."""
    if name not in _CACHE:
        if name == "small":
            cfg = SMALL
            params = jmmt.init_params(cfg, jax.random.PRNGKey(7))
        else:
            from multimodalspectraltransformer_tpu.train import checkpoint

            cfg = ModelConfig()
            params = checkpoint.import_params_msgpack(
                jmmt.init_params(cfg, jax.random.PRNGKey(0)), PHASE3)
        recs = jdp.synthetic_dataset(3, seed=11)
        tb = jdp.collate([jdp.featurize(r, cfg) for r in recs])
        enc = jax.jit(lambda p, b: jmmt.MultimodalTransformer(cfg).apply({"params": p}, b, None, True))(
            params, jax.tree.map(jnp.asarray, tb.inputs))
        sd = tconvert.from_jax_params(params)
        _CACHE[name] = (cfg, params, sd, enc.memory, enc.memory_key_padding_mask)
    return _CACHE[name]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- kernel K1

@pytest.mark.parametrize("pos", [0, 5, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(pos, dtype):
    """Plain K1 against the Pallas kernel in interpret mode: 1e-5 at fp32;
    at bf16 one bf16 rounding of the output (2^-8 relative) apart."""
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((4, 16, 8)).astype(np.float32) / np.sqrt(8)
    kv = rng.standard_normal((4, 16, 16, 12)).astype(np.float32)
    ref = jk1.decode_attention(jnp.asarray(q, dtype), jnp.asarray(kv, dtype), pos, interpret=True)
    tdt = getattr(torch, dtype)
    out = tk1.decode_attention(_t(q).to(tdt), _t(kv).to(tdt), pos)
    assert out.dtype == tdt and out.shape == (4, 16, 8)
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas_at_head_size_16(dtype):
    """Head size 16 (ModelConfig(num_heads=8)), which the kernel now takes:
    plain K1 against the Pallas kernel in interpret mode, same tolerances."""
    rng = np.random.default_rng(16)
    q = rng.standard_normal((4, 8, 16)).astype(np.float32) / 4.0
    kv = rng.standard_normal((4, 8, 32, 12)).astype(np.float32)
    ref = jk1.decode_attention(jnp.asarray(q, dtype), jnp.asarray(kv, dtype), 9, interpret=True)
    tdt = getattr(torch, dtype)
    out = tk1.decode_attention(_t(q).to(tdt), _t(kv).to(tdt), 9)
    assert out.dtype == tdt and out.shape == (4, 8, 16)
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------- step + samplers

@pytest.mark.parametrize("group", [1, 3])
def test_decoder_step_logits_match_jax(group):
    """Three steps of decoder_step from an empty cache, with G decode lanes
    per encoder sample sharing its cross K/V: logits within 1e-4."""
    cfg, params, sd, memory, kpm = _setup("small")
    B = memory.shape[0]
    rng = np.random.default_rng(group)
    jcross = jf.precompute_cross_kv(params, cfg, memory, kpm)
    tcross = tf.precompute_cross_kv(sd, cfg, _t(memory), _t(kpm))
    jstate = jf.init_cache(cfg, B * group)
    tstate = tf.init_cache(cfg, B * group)
    for pos in range(3):
        toks = rng.integers(0, cfg.smiles_vocab_size, B * group)
        jl, jstate = jf.decoder_step(params, cfg, jstate, jnp.asarray(toks), pos, jcross,
                                     group_size=group)
        tl = tf.decoder_step(sd, cfg, tstate, _t(toks), pos, tcross, group_size=group)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for jkv, tkv in zip(jstate.kv_cache, tstate.kv_cache):
        np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=1e-4)


@pytest.mark.parametrize("name", ["small", "phase3"])
def test_greedy_tokens_identical_to_jax(name):
    cfg, params, sd, memory, kpm = _setup(name)
    max_len = min(24, cfg.max_len)
    jr = js.greedy_decode(params, cfg, memory, kpm, 1.0, max_len)
    tr = ts.greedy_decode(sd, cfg, _t(memory), _t(kpm), 1.0, max_len, device="cpu")
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.token_probs.numpy(), np.asarray(jr.token_probs), atol=1e-5)


@pytest.mark.parametrize("name", ["small", "phase3"])
def test_multinomial_tokens_identical_under_jax_noise(name):
    cfg, params, sd, memory, kpm = _setup(name)
    fanout, max_len = 4, min(24, cfg.max_len)
    B = memory.shape[0] * fanout
    rng = jax.random.PRNGKey(5)
    temp = np.linspace(1.0, 1.6, B, dtype=np.float32)[:, None]  # per-lane temperatures
    jr = js.multinomial_decode(params, cfg, memory, kpm, rng, jnp.asarray(temp), max_len,
                               fanout=fanout)
    noise = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(rng, t),
                                                   (B, cfg.smiles_vocab_size)))
                      for t in range(max_len)])
    tr = ts.multinomial_decode(sd, cfg, _t(memory), _t(kpm), None, _t(temp), max_len,
                               fanout=fanout, noise=_t(noise), device="cpu")
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_allclose(tr.token_probs.numpy(), np.asarray(jr.token_probs), atol=1e-5)


def test_bf16_decoding_stays_near_fp32():
    """compute_dtype='bfloat16' (the production setting) against fp32 on the
    phase3 weights: the first step's token probabilities within bf16 level."""
    cfg, _params, sd, memory, kpm = _setup("phase3")
    f32 = ts.greedy_decode(sd, cfg, _t(memory), _t(kpm), 1.0, 1, device="cpu")
    b16 = ts.greedy_decode(sd, cfg, _t(memory), _t(kpm), 1.0, 1, compute_dtype="bfloat16",
                           device="cpu")
    np.testing.assert_allclose(b16.token_probs.numpy(), f32.token_probs.numpy(), atol=0.05)


def test_multinomial_generator_draws_are_reproducible():
    cfg, _params, sd, memory, kpm = _setup("small")
    runs = [ts.multinomial_decode(sd, cfg, _t(memory), _t(kpm), torch.Generator().manual_seed(3),
                                  1.0, 12, fanout=2, device="cpu").tokens for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
