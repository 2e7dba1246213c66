"""Beam search of the port against the JAX package: kernel K3's plain version,
the beam decoder step, and the ancestry beam search itself.

The same numpy inputs (made from a seed) go to both packages. Beam decodes
at float32 must be token-identical, with scores within 1e-4."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.decode import functional as tf
from multimodalspectraltransformer_torch.decode import samplers as ts
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.ops import beam_attention as tk3
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.decode import functional as jf
from multimodalspectraltransformer_tpu.decode import samplers as js
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.ops import beam_attention as jk3
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


def _setup(name: str, n_mols: int = 3):
    """(cfg, JAX params, port state dict, memory, kpm) for 'small' (random
    init), 'real_data' (the same with the use_real_data logit blend) or
    'phase3' (committed weights, full width)."""
    if name not in _CACHE:
        if name == "phase3":
            from multimodalspectraltransformer_tpu.train import checkpoint

            cfg = ModelConfig()
            params = checkpoint.import_params_msgpack(
                jmmt.init_params(cfg, jax.random.PRNGKey(0)), PHASE3)
        else:
            cfg = SMALL if name == "small" else dataclasses.replace(SMALL, use_real_data=True)
            params = jmmt.init_params(cfg, jax.random.PRNGKey(7))
        recs = jdp.synthetic_dataset(n_mols, seed=11)
        tb = jdp.collate([jdp.featurize(r, cfg) for r in recs])
        enc = jax.jit(lambda p, b: jmmt.MultimodalTransformer(cfg).apply({"params": p}, b, None, True))(
            params, jax.tree.map(jnp.asarray, tb.inputs))
        sd = tconvert.from_jax_params(params)
        _CACHE[name] = (cfg, params, sd, np.asarray(enc.memory), np.asarray(enc.memory_key_padding_mask))
    return _CACHE[name]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _random_ancestry(rng, B: int, K: int, T: int, pos: int) -> np.ndarray:
    """[B, K, T] lanes of each beam's ancestors up to ``pos``, its own lane after."""
    anc = rng.integers(0, K, size=(B, K, T)).astype(np.int32)
    anc[:, :, pos + 1 :] = np.arange(K, dtype=np.int32)[None, :, None]
    return anc


def _bias(anc: np.ndarray, pos: int) -> np.ndarray:
    """The JAX ancestry bias (decode/functional.py::beam_decoder_step) in numpy."""
    B, K, T = anc.shape
    ok = (anc[:, :, :, None] == np.arange(K)) & (np.arange(T) <= pos)[None, None, :, None]
    return np.where(ok, 0.0, -np.inf).astype(np.float32).reshape(B, K, T * K)


# ---------------------------------------------------------------- kernel K3

def _k3_inputs(pos: int, B=3, H=4, K=3, Dh=8, T=12):
    rng = np.random.default_rng(100 + pos)
    q = rng.standard_normal((B, H, K, Dh)).astype(np.float32) / np.sqrt(Dh)
    kv = rng.standard_normal((B, H, 2 * Dh, T * K)).astype(np.float32)
    return q, kv, _bias(_random_ancestry(rng, B, K, T, pos), pos)


@pytest.mark.parametrize("pos", [0, 5, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_attention_plain_matches_pallas_and_xla(pos, dtype):
    """Plain K3 against the Pallas kernel in interpret mode and against the
    XLA einsum chain of the JAX beam step, on an ancestry bias: 1e-5 at
    float32; at bfloat16 1e-2 absolute (the XLA chain rounds the scores to
    bf16 as well, the Pallas kernel only the probabilities)."""
    q, kv, bias = _k3_inputs(pos)
    Dh = q.shape[-1]
    jq, jkv, jb = (jnp.asarray(a, dtype) for a in (q, kv, bias))
    pallas = jk3.beam_attention(jq, jkv[:, :, :Dh], jkv[:, :, Dh:], jb, interpret=True)
    scores = jnp.einsum("bhkd,bhdm->bhkm", jq, jkv[:, :, :Dh]) + jb[:, None]
    attn = jax.nn.softmax(scores.astype(jnp.float32), axis=-1).astype(jq.dtype)
    xla = jnp.einsum("bhkm,bhdm->bhkd", attn, jkv[:, :, Dh:])
    tdt = getattr(torch, dtype)
    out = tk3.beam_attention(_t(q).to(tdt), _t(kv).to(tdt), _t(bias).to(tdt), n_live=(pos + 1) * 3)
    assert out.dtype == tdt and out.shape == q.shape
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=0)
    for ref in (pallas, xla):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("pos", [0, 7])
def test_beam_attention_plain_matches_pallas_at_head_size_16_and_20_beams(pos):
    """The shapes the kernel now takes beyond beam mode's: head size 16 and
    K = 20 beams (two groups on the card), plain K3 against the Pallas kernel
    in interpret mode, 1e-5 at float32."""
    q, kv, bias = _k3_inputs(pos, B=2, H=2, K=20, Dh=16, T=8)
    q, Dh = q.astype(np.float32), q.shape[-1]
    pallas = jk3.beam_attention(jnp.asarray(q), jnp.asarray(kv[:, :, :Dh]),
                                jnp.asarray(kv[:, :, Dh:]), jnp.asarray(bias), interpret=True)
    out = tk3.beam_attention(_t(q), _t(kv), _t(bias), n_live=(pos + 1) * 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k, groups", [(1, (1, 1)), (5, (1, 5)), (16, (1, 16)), (17, (2, 9)),
                                       (20, (2, 10)), (33, (3, 11)), (40, (3, 14))])
def test_beam_groups_split_beams_evenly(k, groups):
    """The kernel's beam groups: the fewest groups of at most 16 beams, as even
    as they can be; together they cover every beam once."""
    n, size = tk3.beam_groups(k)
    assert (n, size) == groups
    assert size <= tk3.MAX_GROUP and (n - 1) * size < k <= n * size


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_beam_attention_live_columns_are_the_whole_function(pos):
    """Reading only the first (pos+1)*K columns gives the full-width result:
    the ancestry bias is -inf beyond them (1e-6: only the summation order differs)."""
    q, kv, bias = (_t(a) for a in _k3_inputs(pos))
    part = tk3.beam_attention_plain(q, kv, bias, n_live=(pos + 1) * 3)
    full = tk3.beam_attention_plain(q, kv, bias)
    np.testing.assert_allclose(part.numpy(), full.numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- beam step

def test_beam_decoder_step_matches_jax():
    """Four beam steps with a random ancestry: logits within 1e-4 and every
    cache column the port wrote within 1e-5 of the JAX cache (not bit-equal:
    past the first layer the K/V come out of float sums taken in another
    order)."""
    cfg, params, sd, memory, kpm = _setup("small")
    B, K, T = memory.shape[0], 3, cfg.max_len
    rng = np.random.default_rng(3)
    jcross = jf.precompute_cross_kv(params, cfg, jnp.asarray(memory), jnp.asarray(kpm))
    tcross = tf.precompute_cross_kv(sd, cfg, _t(memory), _t(kpm))
    jstate = jf.init_beam_cache(cfg, B, K)
    tstate = tf.init_beam_cache(cfg, B, K)
    for pos in range(4):
        toks = rng.integers(0, cfg.smiles_vocab_size, B * K)
        anc = _random_ancestry(rng, B, K, T, pos)
        jl, jstate = jf.beam_decoder_step(params, cfg, jstate, jnp.asarray(toks), pos, jcross,
                                          jnp.asarray(anc), K)
        tl = tf.beam_decoder_step(sd, cfg, tstate, _t(toks), pos, tcross, _t(anc), K)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for jkv, tkv in zip(jstate.kv_cache, tstate.kv_cache):
        np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=1e-5)
        assert not tkv[..., 4 * K :].any()  # later steps' columns untouched


def test_ancestry_bias_matches_jax_layout():
    rng = np.random.default_rng(1)
    anc = _random_ancestry(rng, 2, 4, 6, 3)
    bias = tf.ancestry_bias(_t(anc), 3, torch.float32)
    np.testing.assert_array_equal(bias.numpy(), _bias(anc, 3))


# ---------------------------------------------------------------- beam search

@pytest.mark.parametrize("early_exit", [True, False])
def test_beam_search_identical_to_jax_small(early_exit):
    cfg, params, sd, memory, kpm = _setup("small")
    jr = js.beam_search(params, cfg, jnp.asarray(memory), jnp.asarray(kpm), 3, 1.0, 16,
                        early_exit=early_exit)
    tr = ts.beam_search(sd, cfg, _t(memory), _t(kpm), 3, 1.0, 16, early_exit=early_exit,
                        device="cpu")
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), atol=1e-4)


def test_beam_search_identical_to_jax_phase3():
    """The committed phase3 weights at full width, 2 molecules, K=5, 40 steps."""
    cfg, params, sd, memory, kpm = _setup("phase3")
    memory, kpm = memory[:2], kpm[:2]
    jr = js.beam_search(params, cfg, jnp.asarray(memory), jnp.asarray(kpm), 5, 1.0, 40)
    tr = ts.beam_search(sd, cfg, _t(memory), _t(kpm), 5, 1.0, 40, device="cpu")
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), atol=1e-4)
    assert (tr.lengths > 1).all()  # real hypotheses, not a bare <EOS>


@pytest.mark.parametrize("name", ["small", "real_data"])
def test_beam_search_equals_materialized(name):
    """The append-only cache gives what reordering the whole cache gives (the
    real_data config also blends the logits)."""
    cfg, _params, sd, memory, kpm = _setup(name)
    a = ts.beam_search(sd, cfg, _t(memory), _t(kpm), 3, 1.0, 16, device="cpu")
    b = ts.beam_search_materialized(sd, cfg, _t(memory), _t(kpm), 3, 1.0, 16, device="cpu")
    np.testing.assert_array_equal(a.tokens.numpy(), b.tokens.numpy())
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), atol=1e-4)


def test_beam_search_materialized_identical_to_jax():
    cfg, params, sd, memory, kpm = _setup("real_data")
    jr = js.beam_search_materialized(params, cfg, jnp.asarray(memory), jnp.asarray(kpm), 3, 1.0, 16)
    tr = ts.beam_search_materialized(sd, cfg, _t(memory), _t(kpm), 3, 1.0, 16, device="cpu")
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores), atol=1e-4)


def test_beam_size_1_equals_greedy():
    cfg, _params, sd, memory, kpm = _setup("small")
    g = ts.greedy_decode(sd, cfg, _t(memory), _t(kpm), 1.0, 16, device="cpu")
    b = ts.beam_search(sd, cfg, _t(memory), _t(kpm), 1, 1.0, 16, device="cpu")
    np.testing.assert_array_equal(b.tokens[:, 0].numpy(), g.tokens.numpy())


def test_beam_search_bf16_scores_sorted_and_finite():
    """compute_dtype='bfloat16' (the beam-mode setting): beams best-first
    with finite scores, every beam's length within the decode."""
    cfg, _params, sd, memory, kpm = _setup("small")
    r = ts.beam_search(sd, cfg, _t(memory), _t(kpm), 4, 1.0, 16, early_exit=False,
                       compute_dtype="bfloat16", device="cpu")
    s = r.scores.numpy()
    assert r.tokens.shape == (memory.shape[0], 4, 16)
    assert np.isfinite(s).all() and (np.diff(s, axis=1) <= 0).all()
    assert ((r.lengths >= 1) & (r.lengths <= 16)).all()


def test_beam_search_matches_the_reference_loop():
    """The port against the reference-semantics torch beam loop that the JAX
    suite holds its beam search to (``oracle_beam`` in
    test_decode_reference_parity.py), with the same checks: top-1
    token-identical on the decoded region, the same top-k sets, the top-1
    probability within 1e-3 relative of the reference's product."""
    import test_decode_reference_parity as parity

    cfg, params, oracle, j_mem, j_kpm, t_mem, t_kpm = parity._build_pair(seed=1)
    max_len, k = 16, 3
    res = ts.beam_search(tconvert.from_jax_params(params), cfg, _t(j_mem), _t(j_kpm), k, 1.0,
                         max_len, device="cpu")
    ref = parity.oracle_beam(oracle, t_mem, t_kpm, max_len, k)
    tokens, scores = res.tokens.numpy(), res.scores.numpy()
    for b in range(tokens.shape[0]):
        ours = parity._trim(tokens[b])
        theirs = [parity._trim([seq])[0] if len(seq) else [] for _, seq, _ in ref[b]]
        assert ours[0] == theirs[0], b
        assert {tuple(s) for s in ours} == {tuple(s) for s in theirs}, b
        ref_partial = float(np.prod(ref[b][0][2][: len(ours[0])]))
        np.testing.assert_allclose(np.exp(scores[b][0]), ref_partial, rtol=1e-3)
