"""The port's Q-Former / BLIP tower against the JAX package's ``rank/qformer.py``.

The same numpy inputs and the same variables (a JAX ``init_all`` at a small
width, every leaf moved off its init by seeded noise, converted with
``from_jax_blip_params``) go through both packages on the CPU, dropout off.
Tolerances: float32 outputs within 1e-5 * max(1, |x|) of JAX's (float32 sums
in another order); attention maps the same within 1e-6 absolute (they are
probabilities); greedy LM generation token for token; converted BERT weights
exactly (a concatenation and transposes, no arithmetic).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.rank import qformer as tq
from multimodalspectraltransformer_torch.rank.clip import CLIPConfig as TCLIP
from multimodalspectraltransformer_tpu.rank import qformer as jq
from multimodalspectraltransformer_tpu.rank.clip import CLIPConfig as JCLIP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q = dict(hidden=64, num_heads=4, ffn_dim=128, num_layers=4, num_queries=8, encoder_width=64,
         projection_dim=32, dropout=0.0, vocab_size=43, max_text_len=12)
T = dict(text_vocab_size=50, text_hidden=64, text_layers=2, text_heads=4, text_ffn=128,
         text_max_len=32, cb_embedding=64, projection_dim=32, dropout=0.0)
RTOL = 1e-5
_CACHE: dict = {}


def _close(ours, theirs, rtol: float = RTOL) -> None:
    a = np.asarray(ours, np.float64)
    b = np.asarray(theirs, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    excess = np.abs(a - b) - rtol * np.maximum(1.0, np.abs(b))
    assert excess.max() <= 0.0, f"off by {np.abs(a - b).max():.3e}"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _setup():
    """(JAX module, variables, port module, inputs): B=2 molecules, 14 memory
    rows (row 1 masked from 10), 8 text tokens (row 1 padded from 6)."""
    if "blip" not in _CACHE:
        rng = np.random.default_rng(1)
        B, S, L = 2, 14, 8
        tokens = rng.integers(4, 43, (B, L)).astype(np.int32)
        att = np.ones((B, L), np.int32)
        att[1, 6:] = 0
        memory = rng.normal(size=(B, S, 128)).astype(np.float32)
        kpm = np.zeros((B, S), bool)
        kpm[1, 10:] = True
        jm = jq.BLIPRanker(jq.QFormerConfig(**Q), JCLIP(**T))
        v = jm.init(jax.random.PRNGKey(2), jnp.asarray(tokens), jnp.asarray(att),
                    jnp.asarray(memory), jnp.asarray(kpm), method="init_all")
        v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.normal(size=a.shape), a.dtype), v)
        tm = tq.BLIPRanker(tq.QFormerConfig(**Q), TCLIP(**T), memory_width=128)
        tm.load_state_dict(tconvert.from_jax_blip_params(jax.tree.map(np.asarray, v)))
        _CACHE["blip"] = (jm, v, tm.eval(), (tokens, att, memory, kpm))
    return _CACHE["blip"]


def test_blip_embeddings_itm_and_lm_logits_match_jax():
    jm, v, tm, (tokens, att, memory, kpm) = _setup()
    j_args = tuple(jnp.asarray(x) for x in (tokens, att, memory, kpm))
    jt, js = jm.apply(v, *j_args, True)
    with torch.no_grad():
        tt, ts = tm(*(_t(x) for x in (tokens, att, memory, kpm)))
    _close(tt, jt)
    _close(ts, js)
    pad = 1 - att
    for method in ("itm_logits", "lm_logits"):
        j = jm.apply(v, jnp.asarray(tokens), jnp.asarray(pad), jnp.asarray(memory),
                     jnp.asarray(kpm), method=method)
        with torch.no_grad():
            t = getattr(tm, method)(_t(tokens), _t(pad), _t(memory), _t(kpm))
        _close(t, j)


@pytest.mark.parametrize("mode", ["queries", "multimodal", "lm"])
def test_qformer_modes_match_jax(mode):
    """The Q-Former alone on projected memory, in each mode: query states,
    and the text states where text is given."""
    jm, v, tm, (tokens, att, memory, kpm) = _setup()
    qv = {"params": v["params"]["qformer"]}
    p = v["params"]["mmt_proj"]
    mem = jnp.asarray(memory) @ p["kernel"] + p["bias"]
    text = None if mode == "queries" else jnp.asarray(tokens)
    pad = None if mode == "queries" else jnp.asarray(1 - att).astype(bool)
    j = jq.QFormer(jq.QFormerConfig(**Q)).apply(qv, mem, jnp.asarray(kpm), text, pad, mode=mode)
    with torch.no_grad():
        t = tm.qformer(_t(np.asarray(mem)), _t(kpm), None if text is None else _t(tokens),
                       None if pad is None else _t(np.asarray(pad)), mode)
    for a, b in zip((t,) if mode == "queries" else t, (j,) if mode == "queries" else j):
        _close(a, b)


def test_lm_queries_blind_to_text():
    """In LM mode the query states do not depend on the text."""
    _, _, tm, (tokens, att, memory, kpm) = _setup()
    pad = torch.zeros(tokens.shape, dtype=torch.bool)
    with torch.no_grad():
        mem = tm.mmt_proj(_t(memory))
        q1, _ = tm.qformer(mem, _t(kpm), _t(tokens), pad, "lm")
        q2, _ = tm.qformer(mem, _t(kpm), _t((tokens + 7) % 43), pad, "lm")
    torch.testing.assert_close(q1, q2, rtol=0, atol=1e-5)


def test_attention_maps_match_jax():
    jm, v, tm, (_, _, memory, kpm) = _setup()
    qv = {"params": v["params"]["qformer"]}
    p = v["params"]["mmt_proj"]
    mem = np.asarray(jnp.asarray(memory) @ p["kernel"] + p["bias"])
    j = jq.attention_maps(qv, jq.QFormerConfig(**Q), jnp.asarray(mem), jnp.asarray(kpm))
    with torch.no_grad():
        t = tq.attention_maps(tm.qformer, _t(mem), _t(kpm))
    assert set(t) == set(j) == {f"layers_{i}" for i in range(Q["num_layers"])}
    for name, maps in j.items():
        for kind in ("self", "cross"):
            if maps[kind] is None:
                assert t[name][kind] is None, (name, kind)
            else:
                np.testing.assert_allclose(t[name][kind].numpy(), np.asarray(maps[kind]),
                                           rtol=0, atol=1e-6, err_msg=f"{name} {kind}")
    assert t["layers_0"]["cross"].shape == (2, 4, 8, 14) and t["layers_1"]["cross"] is None
    assert tm.training is False


def test_lm_generate_greedy_matches_jax_and_teacher_forcing():
    """Token for token with JAX's cached generation, and with the port's own
    full-prefix teacher-forced roll-out (the cache's correctness); nothing
    but eos after the first eos."""
    jm, v, tm, (_, _, memory, kpm) = _setup()
    max_len = 10
    j = jq.lm_generate_greedy(v, jq.QFormerConfig(**Q), jnp.asarray(memory), jnp.asarray(kpm),
                              max_len)
    t = tq.lm_generate_greedy(tm, _t(memory), _t(kpm), max_len)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    seq = torch.full((2, 1), 3, dtype=torch.long)
    done = torch.zeros(2, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(max_len):
            logits = tm.lm_logits(seq, torch.zeros_like(seq), _t(memory), _t(kpm))
            nxt = torch.where(done, 2, logits[:, -1].argmax(-1))
            done |= nxt == 2
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    torch.testing.assert_close(t, seq[:, 1:], rtol=0, atol=0)
    for row in t:
        hits = (row == 2).nonzero()
        if len(hits):
            assert (row[hits[0, 0]:] == 2).all()
    with pytest.raises(ValueError, match="position table"):
        tq.lm_generate_greedy(tm, _t(memory), _t(kpm), Q["max_text_len"] + 1)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 2)).astype(np.float32)
    labels = np.array([1, 0, 0, 1])
    _close(tq.itm_loss(_t(logits), _t(labels)), jq.itm_loss(jnp.asarray(logits),
                                                             jnp.asarray(labels)))
    lm = rng.normal(size=(3, 7, 43)).astype(np.float32)
    toks = rng.integers(0, 43, (3, 7))
    pad = np.zeros((3, 7), np.float32)
    pad[2, 4:] = 1
    _close(tq.lm_loss(_t(lm), _t(toks), _t(pad)),
           jq.lm_loss(jnp.asarray(lm), jnp.asarray(toks), jnp.asarray(pad)))
    a, b = rng.normal(size=(2, 5, 8)).astype(np.float32)
    out, ref = tq.blip_loss(_t(a), _t(b), 0.7), jq.blip_loss(jnp.asarray(a), jnp.asarray(b), 0.7)
    _close(out.mean_loss, ref.mean_loss)
    _close(out.per_sample_loss, ref.per_sample_loss)


def _bert_state(L: int, d: int, ffn: int, vocab: int, n_pos: int, seed: int = 0) -> dict:
    """A synthetic ``BertModel`` state dict (its keys and shapes, seeded
    values)."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)
    sd = {"embeddings.word_embeddings.weight": r(vocab, d),
          "embeddings.position_embeddings.weight": r(n_pos, d),
          "embeddings.token_type_embeddings.weight": r(2, d),
          "embeddings.LayerNorm.weight": r(d), "embeddings.LayerNorm.bias": r(d)}
    for i in range(L):
        pre = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (ffn, d)), ("output.dense", (d, ffn))):
            sd[f"{pre}.{name}.weight"] = r(*shape)
            sd[f"{pre}.{name}.bias"] = r(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{pre}.{name}.weight"] = r(d)
            sd[f"{pre}.{name}.bias"] = r(d)
    return sd


@pytest.mark.parametrize("vocab", [43, 50])
def test_from_hf_bert_equals_jax(vocab):
    """Every converted array equals JAX's exactly; the embeddings convert
    only where the vocabulary sizes match; the merge loads into the port's
    QFormer, changes its output, and keeps its cross-attention."""
    cfg = dict(Q, num_layers=3, max_text_len=12)
    state = _bert_state(3, 64, 128, vocab, 16)
    ours = tq.from_hf_bert(tq.QFormerConfig(**cfg), state)
    theirs = tconvert.qformer_params(jq.from_hf_bert(jq.QFormerConfig(**cfg), state))
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k
    assert ("text_embeddings.word_embeddings.weight" in ours) == (vocab == cfg["vocab_size"])
    qf = tq.init_tower(tq.QFormer(tq.QFormerConfig(**cfg)), 0).eval()
    memory = torch.ones(2, 5, 64)
    before = qf(memory)
    cross = qf.layers[0].cross_attn.in_proj_weight.clone()
    qf.load_state_dict(tq.merge_params(qf.state_dict(), ours))
    assert not torch.allclose(qf(memory), before)
    assert torch.equal(qf.layers[0].cross_attn.in_proj_weight, cross)


def test_blip_tree_round_trip_and_contrastive_subset():
    """``to_jax_blip_params`` inverts ``from_jax_blip_params`` (keys sorted,
    arrays equal); the contrastive-only state dict converts to exactly the
    tree of a JAX ``init`` of the contrastive towers (no text rows, no ITM or
    LM head)."""
    jm, v, tm, (tokens, att, memory, kpm) = _setup()

    def same(ours, theirs, path=""):
        if isinstance(theirs, dict):
            assert list(ours) == sorted(theirs), path
            for k in theirs:
                same(ours[k], theirs[k], f"{path}/{k}")
        else:
            assert np.array_equal(ours, np.asarray(theirs)), path

    same(tconvert.to_jax_blip_params(tm.state_dict()), v)
    v_contrastive = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in
                                                      (tokens, att, memory, kpm)), True)
    sub = tconvert.to_jax_blip_params(tm.contrastive_state_dict())
    flat = lambda t: {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(sub) == flat(v_contrastive)
    assert all(tq.is_contrastive_param(k) == (k in tm.contrastive_state_dict())
               for k in tm.state_dict())


def test_dropout_keep_rate_and_repeats():
    """In train mode with a generator: the same seed gives the same
    embeddings, another seed others; without a generator, or in eval mode,
    no dropout. The Q-Former's text-embedding dropout keeps 1 - p of the
    elements, the kept ones scaled by 1 / (1 - p)."""
    cfg = tq.QFormerConfig(**dict(Q, dropout=0.1))
    model = tq.init_tower(tq.BLIPRanker(cfg, TCLIP(**dict(T, dropout=0.1)), 128), 0).train()
    _, _, _, (tokens, att, memory, kpm) = _setup()
    args = tuple(_t(x) for x in (tokens, att, memory, kpm))
    gen = lambda s: torch.Generator().manual_seed(s)
    with torch.no_grad():
        a, b, c = (model(*args, generator=gen(s)) for s in (5, 5, 6))
        plain = model(*args)
        model.eval()
        ev = model(*args, generator=gen(5))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert not torch.equal(a[1], ev[1])
    for x, y in zip(plain, ev):
        assert torch.equal(x, y)
    emb = model.qformer.text_embeddings.train()
    emb.norm.weight.data.fill_(1.0)
    emb.norm.bias.data.fill_(5.0)  # every normalized element near 5, none zero
    with torch.no_grad():
        y = emb(torch.zeros(400, 12, dtype=torch.long), seed=1)
        base = emb.eval()(torch.zeros(400, 12, dtype=torch.long))
    kept = y != 0
    n = kept.numel()
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.09 / n) ** 0.5
    torch.testing.assert_close(y[kept], (base / 0.9)[kept])
