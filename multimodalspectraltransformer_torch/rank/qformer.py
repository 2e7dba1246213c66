"""Q-Former (BLIP-2 style) spectrum <-> SMILES alignment.

Counterpart of the JAX package's ``rank/qformer.py``: 32 learned query tokens
run through a BERT-depth post-LN encoder whose layers cross-attend to the
projected MMT memory every ``cross_attention_frequency`` layers; the
spectrum embedding projects query token 0, the text embedding the CLS state
of a Roberta-style text tower (``rank/clip.py``), and both meet in the CLIP
loss (``blip_loss``). Beside the contrastive towers:

- the text path (``TextEmbeddings``): the Q-Former encodes token sequences;
- the multimodal (ITM) path: [queries; text] encoded together with
  bidirectional attention, cross-attention on the query rows only, and a
  2-way match head averaged over the query positions (``itm_logits``);
- the LM path: causal text over the query prefix, queries blind to the text
  (an additive -1e9 mask), and a prediction head whose decoder is the word
  embedding itself, one ``Parameter`` read twice (``lm_logits``); greedy
  generation with a per-layer past K/V cache (``lm_generate_greedy``);
- text rows use their own feed-forward weights (``*_text``).

Parameter names follow the JAX tree (``models/convert.py::
from_jax_blip_params``). LayerNorms use eps 1e-12 (BERT's), the GELUs are
exact. Dropout sits where flax has it and runs in ``train()`` mode when a
``generator`` is passed, one seed per module drawn from it. The JAX towers
run their attention as plain einsum/softmax and reach no Pallas kernel; so
does this module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn

from ..models.layers import (LayerNorm, Linear, MultiheadAttention, dropout, gelu_exact,
                             init_like_flax, make_generator)
from ..models.mmt import split_generator
from ..ops.embedding_grad import embedding_lookup
from .clip import (CLIPConfig, ProjectionHead, RobertaStyleEncoder, _f32, clip_loss,
                   dropout_seeds)

NEG_INF = -1e9
LN_EPS = 1e-12


@dataclass(frozen=True)
class QFormerConfig:
    hidden: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    num_layers: int = 12  # bert-base depth
    num_queries: int = 32
    cross_attention_frequency: int = 2
    dropout: float = 0.1
    encoder_width: int = 768  # projected MMT memory dim
    projection_dim: int = 512
    temperature: float = 1.0
    # text side (SMILES tokens by default; bert vocab when seeded from HF)
    vocab_size: int = 43
    max_text_len: int = 64


class TextEmbeddings(nn.Module):
    """BERT embeddings: word + learned position, LayerNorm(1e-12), dropout."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.p = cfg.dropout
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.max_text_len, cfg.hidden))
        self.norm = LayerNorm(cfg.hidden, eps=LN_EPS)

    def forward(self, tokens: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        x = (embedding_lookup(self.word_embeddings.weight, tokens)
             + self.position_embeddings[None, : tokens.shape[1]])
        x = self.norm(x)
        return dropout(x, self.p, make_generator(seed, x.device) if self.training else None)


class QFormerLayer(nn.Module):
    """Post-LN BERT layer over [queries; text] rows: self-attention over all
    rows, cross-attention to the memory on the query rows only (when
    ``has_cross``), and separate feed-forward weights for the text rows."""

    def __init__(self, cfg: QFormerConfig, has_cross: bool):
        super().__init__()
        d = cfg.hidden
        self.p = cfg.dropout
        self.has_cross = has_cross
        self.self_attn = MultiheadAttention(d, cfg.num_heads, cfg.dropout)
        self.norm1 = LayerNorm(d, eps=LN_EPS)
        if has_cross:
            self.cross_attn = MultiheadAttention(d, cfg.num_heads, cfg.dropout)
            self.norm_cross = LayerNorm(d, eps=LN_EPS)
        for suffix in ("", "_text"):
            self.add_module(f"linear1{suffix}", Linear(d, cfg.ffn_dim))
            self.add_module(f"linear2{suffix}", Linear(cfg.ffn_dim, d))
            self.add_module(f"norm2{suffix}", LayerNorm(d, eps=LN_EPS))

    def ffn(self, rows: torch.Tensor, suffix: str, gen: Optional[torch.Generator] = None
            ) -> torch.Tensor:
        """Linear -> exact GELU -> Linear -> dropout -> +residual -> LayerNorm,
        with the query (``""``) or text (``"_text"``) weights."""
        y = getattr(self, f"linear2{suffix}")(gelu_exact(getattr(self, f"linear1{suffix}")(rows)))
        return getattr(self, f"norm2{suffix}")(rows + dropout(y, self.p, gen))

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                memory_kpm: Optional[torch.Tensor], attn_mask: Optional[torch.Tensor] = None,
                self_kpm: Optional[torch.Tensor] = None, query_length: Optional[int] = None,
                seed: Optional[int] = None, maps: Optional[dict] = None) -> torch.Tensor:
        """``x`` [B, Q+T, D] (query rows first); ``query_length``: rows
        0..Q-1 are queries (None: all); ``maps``: filled with the softmax
        weights, ``"self"`` [B, H, Q+T, Q+T] and ``"cross"`` [B, H, Q, S]
        (None without cross-attention)."""
        gen = make_generator(seed, x.device) if self.training else None
        ql = x.shape[1] if query_length is None else query_length
        want = maps is not None
        sa = self.self_attn(x, x, x, attn_mask, self_kpm, gen, need_weights=want)
        if want:
            sa, maps["self"] = sa
            maps["cross"] = None
        x = self.norm1(x + dropout(sa, self.p, gen))
        if self.has_cross and ql > 0:
            q_rows = x[:, :ql]
            ca = self.cross_attn(q_rows, memory, memory, key_padding_mask=memory_kpm, gen=gen,
                                 need_weights=want)
            if want:
                ca, maps["cross"] = ca
            q_rows = self.norm_cross(q_rows + dropout(ca, self.p, gen))
            x = torch.cat([q_rows, x[:, ql:]], dim=1) if ql < x.shape[1] else q_rows
        if ql >= x.shape[1]:
            return self.ffn(x, "", gen)
        if ql == 0:
            return self.ffn(x, "_text", gen)
        return torch.cat([self.ffn(x[:, :ql], "", gen), self.ffn(x[:, ql:], "_text", gen)], dim=1)


class QFormer(nn.Module):
    """Query tower with the text, multimodal and LM surfaces."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.query_tokens = nn.Parameter(torch.zeros(cfg.num_queries, cfg.hidden))
        self.text_embeddings = TextEmbeddings(cfg)
        self.layers = nn.ModuleList(QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
                                    for i in range(cfg.num_layers))

    def forward(self, memory: torch.Tensor, memory_kpm: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None, text_mask: Optional[torch.Tensor] = None,
                mode: str = "queries", generator: Optional[torch.Generator] = None,
                maps: Optional[list] = None):
        """``memory`` [B, S, D_enc] (projected), ``memory_kpm`` [B, S] (True =
        masked), ``text`` [B, T] ids, ``text_mask`` [B, T] (True = padding);
        ``mode``: "queries", "multimodal" or "lm". -> the query states [B, Q,
        D] without text, else (query states, text states). ``maps``: a list
        that receives each layer's attention weights (``QFormerLayer``)."""
        c = self.cfg
        if mode not in ("queries", "multimodal", "lm"):
            raise ValueError(f"mode must be queries, multimodal or lm, got {mode!r}")
        seeds = dropout_seeds(self, c.dropout, generator, 1 + c.num_layers)
        B = memory.shape[0]
        ql = c.num_queries
        parts = [self.query_tokens[None].expand(B, -1, -1)]
        t_len = 0
        if text is not None:
            parts.append(self.text_embeddings(text, seeds[0]))
            t_len = text.shape[1]
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

        attn_mask = None
        if mode == "lm" and t_len:
            # queries blind to the text; text causal over itself, full over queries
            n = ql + t_len
            attn_mask = torch.zeros(n, n, device=x.device)
            attn_mask[:ql, ql:] = NEG_INF
            attn_mask[ql:, ql:] = torch.full((t_len, t_len), NEG_INF, device=x.device).triu(1)
        self_kpm = None
        if t_len:
            pad = (text_mask.bool() if text_mask is not None
                   else torch.zeros(text.shape, dtype=torch.bool, device=x.device))
            self_kpm = torch.cat([torch.zeros(B, ql, dtype=torch.bool, device=x.device), pad], 1)

        for layer, seed in zip(self.layers, seeds[1:]):
            layer_maps = None
            if maps is not None:
                layer_maps = {}
                maps.append(layer_maps)
            x = layer(x, memory, memory_kpm, attn_mask, self_kpm, ql, seed, layer_maps)
        if t_len == 0:
            return x
        return x[:, :ql], x[:, ql:]


class LMPredictionHead(nn.Module):
    """BertLMPredictionHead: Linear -> exact GELU -> LayerNorm -> the word
    embeddings as decoder (tied: the caller passes the Q-Former's own
    embedding ``Parameter``) plus a bias."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.transform = Linear(cfg.hidden, cfg.hidden)
        self.transform_norm = LayerNorm(cfg.hidden, eps=LN_EPS)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden: torch.Tensor, word_embeddings: torch.Tensor) -> torch.Tensor:
        x = self.transform_norm(gelu_exact(self.transform(hidden)))
        return x @ word_embeddings.T + self.bias


# the parameters only the Q-Former's text rows and the ITM and LM heads read:
# the contrastive objective leaves them untouched, and the JAX package's
# contrastive trainer never creates them
_HEAD_ONLY = ("qformer.text_embeddings.", "itm_head.", "lm_head.")
_TEXT_FFN = ("linear1_text.", "linear2_text.", "norm2_text.")


def is_contrastive_param(name: str) -> bool:
    """Whether a ``BLIPRanker`` parameter is read by the contrastive towers
    (``forward``), and so trained by ``train/contrastive.py``."""
    return not (name.startswith(_HEAD_ONLY) or any(f".{s}" in name for s in _TEXT_FFN))


class BLIPRanker(nn.Module):
    """Spectrum side: MMT memory -> Linear -> Q-Former -> query-0 projection;
    text side: Roberta-style tower -> CLS projection. Plus the ITM and LM
    heads. ``memory_width``: the MMT's hidden size."""

    def __init__(self, qcfg: QFormerConfig, tcfg: CLIPConfig, memory_width: int = 128):
        super().__init__()
        self.qcfg, self.tcfg = qcfg, tcfg
        self.mmt_proj = Linear(memory_width, qcfg.encoder_width)
        self.qformer = QFormer(qcfg)
        self.text_encoder = RobertaStyleEncoder(tcfg)
        self.spec_projection = ProjectionHead(qcfg.hidden, qcfg.projection_dim, qcfg.dropout)
        self.text_projection = ProjectionHead(tcfg.text_hidden, qcfg.projection_dim, qcfg.dropout)
        self.itm_head = Linear(qcfg.hidden, 2)
        self.lm_head = LMPredictionHead(qcfg)

    def embed_spectrum(self, memory: torch.Tensor, memory_kpm: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g_qf, g_head = split_generator(generator, 2)
        q = self.qformer(self.mmt_proj(memory), memory_kpm, generator=g_qf)
        (seed,) = dropout_seeds(self, self.qcfg.dropout, g_head, 1)
        return self.spec_projection(q[:, 0, :], seed)  # query token 0

    def embed_text(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g_enc, g_head = split_generator(generator, 2)
        pooled = self.text_encoder(tokens, attention_mask, generator=g_enc)
        (seed,) = dropout_seeds(self, self.qcfg.dropout, g_head, 1)
        return self.text_projection(pooled, seed)

    def itm_logits(self, tokens: torch.Tensor, text_pad: torch.Tensor, memory: torch.Tensor,
                   memory_kpm: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, 2] match logits: queries and text encoded together, the
        per-query 2-way logits averaged."""
        q_states, _ = self.qformer(self.mmt_proj(memory), memory_kpm, tokens, text_pad,
                                   "multimodal", generator)
        return self.itm_head(q_states).mean(dim=1)

    def lm_logits(self, tokens: torch.Tensor, text_pad: torch.Tensor, memory: torch.Tensor,
                  memory_kpm: Optional[torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, V] next-token logits of causal text over the query prefix."""
        _, t_states = self.qformer(self.mmt_proj(memory), memory_kpm, tokens, text_pad, "lm",
                                   generator)
        return self.lm_head(t_states, self.qformer.text_embeddings.word_embeddings.weight)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor, memory: torch.Tensor,
                memory_kpm: Optional[torch.Tensor], generator: Optional[torch.Generator] = None):
        """-> (text embeddings, spectrum embeddings)."""
        g_text, g_spec = split_generator(generator, 2)
        return (self.embed_text(tokens, attention_mask, g_text),
                self.embed_spectrum(memory, memory_kpm, g_spec))

    def init_all(self, tokens, attention_mask, memory, memory_kpm):
        """Every head at once (the contrastive towers, ITM, LM), as the JAX
        module's ``init_all`` touches them."""
        text, spec = self(tokens, attention_mask, memory, memory_kpm)
        pad = 1 - attention_mask.int()
        return (text, spec, self.itm_logits(tokens, pad, memory, memory_kpm),
                self.lm_logits(tokens, pad, memory, memory_kpm))

    def contrastive_state_dict(self) -> dict[str, torch.Tensor]:
        """The state dict without the leaves only the ITM/LM surfaces read:
        the tree the JAX package's contrastive trainer writes."""
        return {k: v for k, v in self.state_dict().items() if is_contrastive_param(k)}


def default_text_config(qcfg: QFormerConfig) -> CLIPConfig:
    """The BLIP text tower the JAX trainer builds: 2 layers, 4 heads, the
    Q-Former's encoder width."""
    return CLIPConfig(text_layers=2, text_heads=4, text_hidden=qcfg.encoder_width,
                      text_ffn=4 * qcfg.encoder_width, cb_embedding=qcfg.encoder_width,
                      projection_dim=qcfg.projection_dim)


@torch.no_grad()
def init_tower(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw a CLIP or BLIP tower's parameters from ``seed`` with the JAX
    package's initializers (``init_like_flax``; the Q-Former's query tokens
    and text positions normal(0.02); zero type embedding and LM bias)."""
    gen = torch.Generator().manual_seed(seed)
    init_like_flax(model, gen)
    for mod in model.modules():
        if isinstance(mod, QFormer):
            nn.init.normal_(mod.query_tokens, std=0.02, generator=gen)
            nn.init.normal_(mod.text_embeddings.position_embeddings, std=0.02, generator=gen)
        elif isinstance(mod, RobertaStyleEncoder):
            mod.token_type_embedding.zero_()
        elif isinstance(mod, LMPredictionHead):
            mod.bias.zero_()
    return model


def blip_loss(text_emb: torch.Tensor, spec_emb: torch.Tensor, temperature: float = 1.0):
    """The CLIP loss (soft targets, symmetric) on the BLIP embeddings."""
    return clip_loss(text_emb, spec_emb, temperature)


def itm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """2-way cross-entropy of spectrum-text matching."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, text_pad: torch.Tensor) -> torch.Tensor:
    """Shifted cross-entropy: position t predicts token t+1; padding left out."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    keep = 1.0 - text_pad[:, 1:].float()
    return (nll * keep).sum() / keep.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# greedy LM generation over a past K/V cache
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, S, d = x.shape
    return x.reshape(B, S, h, d // h).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int,
            kpm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Sq, D] over k/v [B, S, D] -> [B, Sq, D]; ``kpm`` [B, S] True =
    masked (added as -1e9)."""
    B, Sq, d = q.shape
    scores = (_heads(q, h) / (d // h) ** 0.5) @ _heads(k, h).transpose(-1, -2)
    if kpm is not None:
        scores = scores + torch.where(kpm[:, None, None, :], NEG_INF, 0.0)
    out = torch.softmax(scores, dim=-1) @ _heads(v, h)
    return out.transpose(1, 2).reshape(B, Sq, d)


def _in_proj(attn: MultiheadAttention, x: torch.Tensor, part: int) -> torch.Tensor:
    """The query (0), key (1) or value (2) projection of ``attn``."""
    d = attn.embed_dim
    w = attn.in_proj_weight[part * d : (part + 1) * d]
    return x @ w.T + attn.in_proj_bias[part * d : (part + 1) * d]


@torch.no_grad()
def lm_generate_greedy(model: BLIPRanker, memory: torch.Tensor,
                       memory_kpm: Optional[torch.Tensor], max_len: int, sos: int = 3,
                       eos: int = 2) -> torch.Tensor:
    """Greedy SMILES from the LM head: the query prefix runs through the
    stack once and each layer keeps its self-attention K/V; each text step
    appends one K/V row per layer and attends over the rows so far. Lanes
    that emit ``eos`` are frozen (every later token is ``eos``). ``memory``
    [B, S, memory_width] is the raw MMT memory, on the model's device.
    Returns [B, max_len] ids (at most ``max_text_len`` steps)."""
    c = model.qcfg
    if max_len > c.max_text_len:
        raise ValueError(f"max_len {max_len} exceeds the position table ({c.max_text_len})")
    qf = model.qformer
    h, Q = c.num_heads, c.num_queries
    B = memory.shape[0]
    dev = memory.device
    mem = model.mmt_proj(memory)

    # the query prefix: full self-attention among the queries, cross-attention
    # to the memory, the query FFN; each layer caches its input rows' K/V
    x = qf.query_tokens[None].expand(B, -1, -1)
    ks, vs = [], []
    for layer in qf.layers:
        sa = layer.self_attn
        k, v = _in_proj(sa, x, 1), _in_proj(sa, x, 2)
        x2 = layer.norm1(x + sa.out_proj(_attend(_in_proj(sa, x, 0), k, v, h)))
        if layer.has_cross:
            ca = layer.cross_attn
            att = _attend(_in_proj(ca, x2, 0), _in_proj(ca, mem, 1), _in_proj(ca, mem, 2), h,
                          memory_kpm)
            x2 = layer.norm_cross(x2 + ca.out_proj(att))
        x = layer.ffn(x2, "")
        k_cache = torch.zeros(B, Q + max_len, c.hidden, device=dev)
        v_cache = torch.zeros_like(k_cache)
        k_cache[:, :Q], v_cache[:, :Q] = k, v
        ks.append(k_cache)
        vs.append(v_cache)

    emb = qf.text_embeddings
    word = emb.word_embeddings.weight
    tokens = torch.full((B, max_len + 1), sos, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(max_len):
        xt = emb.norm(word[tokens[:, t]][:, None, :] + emb.position_embeddings[t])
        col = Q + t
        for layer, k_cache, v_cache in zip(qf.layers, ks, vs):
            sa = layer.self_attn
            k_cache[:, col] = _in_proj(sa, xt, 1)[:, 0]
            v_cache[:, col] = _in_proj(sa, xt, 2)[:, 0]
            att = _attend(_in_proj(sa, xt, 0), k_cache[:, : col + 1], v_cache[:, : col + 1], h)
            # text rows: no cross-attention, the text FFN
            xt = layer.ffn(layer.norm1(xt + sa.out_proj(att)), "_text")
        logits = model.lm_head(xt[:, 0], word)
        nxt = torch.where(done, eos, logits.argmax(dim=-1))
        done = done | (nxt == eos)
        tokens[:, t + 1] = nxt
    return tokens[:, 1:]


@torch.no_grad()
def attention_maps(qformer: QFormer, memory: torch.Tensor,
                   memory_kpm: Optional[torch.Tensor] = None) -> dict[str, dict]:
    """The Q-Former's attention weights over projected ``memory``, for
    explainability: {``layers_i``: {"self": [B, H, Q, Q], "cross": [B, H,
    Q, S] or None}}."""
    maps: list = []
    was_training = qformer.training
    qformer.eval()
    try:
        qformer(memory, memory_kpm, maps=maps)
    finally:
        qformer.train(was_training)
    return {f"layers_{i}": m for i, m in enumerate(maps)}


# ---------------------------------------------------------------------------
# BERT weights
# ---------------------------------------------------------------------------

def from_hf_bert(qcfg: QFormerConfig, hf_state: Mapping) -> dict[str, torch.Tensor]:
    """A ``transformers.BertModel`` state dict -> the matching part of the
    ``QFormer`` state dict: self-attention, feed-forward and norms of the
    first ``qcfg.num_layers`` layers, the text FFNs from the same BERT
    weights, and the word/position embeddings when the vocabulary sizes
    match. Cross-attention has no BERT counterpart and keeps its own
    weights: merge the result over a state dict (``merge_params``)."""
    t = lambda key: _f32(hf_state[key])
    out: dict[str, torch.Tensor] = {}
    for i in range(qcfg.num_layers):
        pre, ours = f"encoder.layer.{i}", f"layers.{i}"
        att = f"{pre}.attention.self"
        out[f"{ours}.self_attn.in_proj_weight"] = torch.cat(
            [t(f"{att}.{x}.weight") for x in ("query", "key", "value")])
        out[f"{ours}.self_attn.in_proj_bias"] = torch.cat(
            [t(f"{att}.{x}.bias") for x in ("query", "key", "value")])
        pairs = [("attention.output.dense", "self_attn.out_proj"),
                 ("attention.output.LayerNorm", "norm1")]
        for suffix in ("", "_text"):
            pairs += [("intermediate.dense", f"linear1{suffix}"),
                      ("output.dense", f"linear2{suffix}"),
                      ("output.LayerNorm", f"norm2{suffix}")]
        for theirs, mine in pairs:
            out[f"{ours}.{mine}.weight"] = t(f"{pre}.{theirs}.weight")
            out[f"{ours}.{mine}.bias"] = t(f"{pre}.{theirs}.bias")
    if "embeddings.word_embeddings.weight" in hf_state:
        we = t("embeddings.word_embeddings.weight")
        if we.shape[0] == qcfg.vocab_size:
            out["text_embeddings.word_embeddings.weight"] = we
            out["text_embeddings.position_embeddings"] = (
                t("embeddings.position_embeddings.weight")[: qcfg.max_text_len].clone())
            out["text_embeddings.norm.weight"] = t("embeddings.LayerNorm.weight")
            out["text_embeddings.norm.bias"] = t("embeddings.LayerNorm.bias")
    return out


def merge_params(base: Mapping, overlay: Mapping) -> dict:
    """``base`` with every entry of ``overlay`` put over it (state dicts)."""
    return {**base, **overlay}
