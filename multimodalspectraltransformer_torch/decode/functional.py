"""KV-cached decoder primitives over the model's state dict.

Counterpart of the JAX package's ``decode/functional.py``:

- the self-attention cache is one MERGED buffer per decoder layer,
  ``[B, H, 2*Dh, T]`` with K in rows 0:Dh and V in rows Dh:2*Dh (the JAX
  layout, kept so kernel K1 sees the same operand as its Pallas original);
  the port writes each step's column IN PLACE instead of returning a new
  buffer,
- cross-attention K/V are projected from the encoder memory once per
  generation, per encoder SAMPLE: with ``group_size=G`` the batch holds G
  decode lanes per sample and the lanes share their sample's K/V (the
  memory is never duplicated G ways),
- the causal self-attention of every step is kernel K1
  (``ops/decode_attention.py``),
- beam search keeps an APPEND-ONLY cache ``[B, H, 2*Dh, T*K]`` (the K lanes
  of step t in columns t*K .. t*K+K-1) that is never reordered: each beam
  attends over every lane's columns under an ancestry bias that keeps, per
  past step, the lane that held its ancestor then (kernel K3,
  ``ops/beam_attention.py``).

``params`` is the flat state dict of ``models.mmt.MultimodalTransformer``
(``model.state_dict()``), optionally cast by ``samplers._cast_decode_params``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.beam_attention import beam_attention
from ..ops.decode_attention import decode_attention
from ..utils.config import ModelConfig

Params = Mapping[str, torch.Tensor]


def _ln(x: torch.Tensor, params: Params, prefix: str, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * params[f"{prefix}.weight"] + params[f"{prefix}.bias"]


def _split_heads_t(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, Dh, S] (sequence-minor KV layout)."""
    B, S, D = x.shape
    return x.reshape(B, S, h, D // h).permute(0, 2, 3, 1)


class DecodeState(NamedTuple):
    """One merged ``[B, H, 2*Dh, T]`` K/V buffer per decoder layer."""

    kv_cache: tuple[torch.Tensor, ...]


class CrossKV(NamedTuple):
    k: tuple[torch.Tensor, ...]  # per layer [Bs, H, Dh, S_mem]
    v: tuple[torch.Tensor, ...]
    mask_bias: torch.Tensor  # [Bs, 1, 1, S_mem] additive 0/-inf from key padding


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> DecodeState:
    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    shape = (batch, H, 2 * Dh, cfg.max_len)
    return DecodeState(tuple(torch.zeros(shape, dtype=dtype, device=device)
                             for _ in range(cfg.num_decoder_layers)))


def precompute_cross_kv(params: Params, cfg: ModelConfig, memory: torch.Tensor,
                        memory_kpm: torch.Tensor) -> CrossKV:
    """Project the encoder memory [B, S, D] into per-layer cross K/V once."""
    H, D = cfg.num_heads, cfg.hidden_size
    ks, vs = [], []
    for i in range(cfg.num_decoder_layers):
        w = params[f"decoder.layers.{i}.multihead_attn.in_proj_weight"]
        b = params[f"decoder.layers.{i}.multihead_attn.in_proj_bias"]
        ks.append(_split_heads_t(F.linear(memory, w[D : 2 * D], b[D : 2 * D]), H))
        vs.append(_split_heads_t(F.linear(memory, w[2 * D :], b[2 * D :]), H))
    bias = torch.zeros(memory_kpm.shape, dtype=memory.dtype, device=memory.device)
    bias = bias.masked_fill(memory_kpm.bool(), float("-inf"))[:, None, None, :]
    return CrossKV(tuple(ks), tuple(vs), bias)


def decoder_step(
    params: Params,
    cfg: ModelConfig,
    state: DecodeState,
    tokens: torch.Tensor,  # [B] current input token
    pos: int,  # position of `tokens`
    cross: CrossKV,
    blend: Optional[torch.Tensor] = None,  # [B, vocab] real-data blend
    group_size: int = 1,
) -> torch.Tensor:
    """One incremental decoder step: writes column ``pos`` of every layer's
    cache in place and returns the logits [B, vocab]."""
    D, H = cfg.hidden_size, cfg.num_heads
    Dh = D // H
    x = params["embed_trg.weight"][tokens] + params["pe_trg.weight"][pos]  # [B, D]
    B = x.shape[0]
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=x.dtype, device=x.device))

    for i in range(cfg.num_decoder_layers):
        p = f"decoder.layers.{i}"
        # ---- causal self-attention over the cache (kernel K1) ----
        qkv = F.linear(x, params[f"{p}.self_attn.in_proj_weight"], params[f"{p}.self_attn.in_proj_bias"])
        q, k, v = qkv.reshape(B, 3, H, Dh).unbind(1)
        kv_i = state.kv_cache[i]
        kv_i[:, :, :Dh, pos] = k
        kv_i[:, :, Dh:, pos] = v
        sa = decode_attention((q * scale).contiguous(), kv_i, pos).reshape(B, D)
        x = _cross_and_ffn(params, cfg, i, x, sa, cross, group_size, scale)

    logits = F.linear(x, params["fc_out.weight"], params["fc_out.bias"])
    if blend is not None:
        logits = (logits + blend) / 2
    return logits


def _cross_and_ffn(params: Params, cfg: ModelConfig, i: int, x: torch.Tensor, sa: torch.Tensor,
                   cross: CrossKV, G: int, scale: torch.Tensor) -> torch.Tensor:
    """The rest of decoder layer ``i`` after its self-attention ``sa`` [B, D]:
    output projection and norm1, cross-attention over the per-sample memory
    K/V (the batch holds G lanes per sample, which share its K/V) and norm2,
    feed-forward and norm3."""
    D, H = cfg.hidden_size, cfg.num_heads
    Dh = D // H
    eps = cfg.layer_norm_eps
    B = x.shape[0]
    p = f"decoder.layers.{i}"
    sa = F.linear(sa, params[f"{p}.self_attn.out_proj.weight"], params[f"{p}.self_attn.out_proj.bias"])
    x = _ln(x + sa, params, f"{p}.norm1", eps)

    # ---- cross-attention over the per-sample memory K/V ----
    w = params[f"{p}.multihead_attn.in_proj_weight"]
    b = params[f"{p}.multihead_attn.in_proj_bias"]
    q2 = F.linear(x, w[:D], b[:D])
    # lanes of one sample share its K/V: G acts as a query axis
    q2 = q2.reshape(B // G, G, H, Dh).transpose(1, 2) * scale  # [Bs, H, G, Dh]
    scores = q2 @ cross.k[i] + cross.mask_bias  # [Bs, H, G, S]
    attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ca = (attn @ cross.v[i].transpose(-1, -2)).transpose(1, 2).reshape(B, D)
    ca = F.linear(ca, params[f"{p}.multihead_attn.out_proj.weight"],
                  params[f"{p}.multihead_attn.out_proj.bias"])
    x = _ln(x + ca, params, f"{p}.norm2", eps)

    # ---- feed-forward ----
    y = F.relu(F.linear(x, params[f"{p}.linear1.weight"], params[f"{p}.linear1.bias"]))
    y = F.linear(y, params[f"{p}.linear2.weight"], params[f"{p}.linear2.bias"])
    return _ln(x + y, params, f"{p}.norm3", eps)


def init_beam_cache(cfg: ModelConfig, batch: int, beam_size: int, dtype=torch.float32,
                    device=None) -> DecodeState:
    """Beam-mode cache, one ``[B, H, 2*Dh, T*K]`` buffer per decoder layer,
    the K lanes of step t in columns t*K .. t*K+K-1."""
    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    shape = (batch, H, 2 * Dh, cfg.max_len * beam_size)
    return DecodeState(tuple(torch.zeros(shape, dtype=dtype, device=device)
                             for _ in range(cfg.num_decoder_layers)))


def gather_lanes(state: DecodeState, idx: torch.Tensor) -> DecodeState:
    """Reorder the lane axis of every cache buffer (materialized beam search)."""
    return DecodeState(tuple(kv[idx] for kv in state.kv_cache))


def ancestry_bias(ancestry: torch.Tensor, pos: int, dtype) -> torch.Tensor:
    """[B, K, T] lane holding each beam's ancestor at step t -> the additive
    self-attention bias [B, K, T*K] in the cache's column order: 0 at
    (t, ancestry[b, k, t]) for t <= pos, -inf elsewhere."""
    B, K, T = ancestry.shape
    dev = ancestry.device
    ok = ancestry[:, :, :, None] == torch.arange(K, device=dev)
    ok &= (torch.arange(T, device=dev) <= pos)[None, None, :, None]
    return torch.where(ok, 0.0, float("-inf")).to(dtype).reshape(B, K, T * K)


def beam_decoder_step(
    params: Params,
    cfg: ModelConfig,
    state: DecodeState,  # init_beam_cache layout
    tokens: torch.Tensor,  # [B*K] current token of each beam lane
    pos: int,
    cross: CrossKV,  # from the un-duplicated memory ([B] samples)
    ancestry: torch.Tensor,  # [B, K, T] lane holding each beam's ancestor at step t
    beam_size: int,
) -> torch.Tensor:
    """One beam step over the append-only cache: writes the [B, H, 2*Dh, K]
    block of step ``pos`` in place (the cache is never reordered) and returns
    the logits [B*K, vocab]. Each beam's self-attention runs over every
    lane's columns 0 .. (pos+1)*K - 1 under the ancestry bias (kernel K3)."""
    D, H = cfg.hidden_size, cfg.num_heads
    Dh = D // H
    K = beam_size
    x = params["embed_trg.weight"][tokens] + params["pe_trg.weight"][pos]  # [B*K, D]
    BK = x.shape[0]
    B = BK // K
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh), dtype=x.dtype, device=x.device))
    bias_km = ancestry_bias(ancestry, pos, x.dtype)  # shared by every layer
    cols = slice(pos * K, (pos + 1) * K)

    for i in range(cfg.num_decoder_layers):
        p = f"decoder.layers.{i}"
        qkv = F.linear(x, params[f"{p}.self_attn.in_proj_weight"], params[f"{p}.self_attn.in_proj_bias"])
        q, k, v = qkv.reshape(B, K, 3, H, Dh).unbind(2)
        kv_i = state.kv_cache[i]
        kv_i[:, :, :Dh, cols] = k.permute(0, 2, 3, 1)
        kv_i[:, :, Dh:, cols] = v.permute(0, 2, 3, 1)
        qb = (q.transpose(1, 2) * scale).contiguous()  # [B, H, K, Dh]
        sa = beam_attention(qb, kv_i, bias_km, n_live=(pos + 1) * K)
        x = _cross_and_ffn(params, cfg, i, x, sa.transpose(1, 2).reshape(BK, D), cross, K, scale)

    return F.linear(x, params["fc_out.weight"], params["fc_out.bias"])


def real_data_blend(params: Params, memory: torch.Tensor) -> torch.Tensor:
    """real_data_linear(mean(memory)) -> [B, vocab] (``use_real_data``)."""
    return F.linear(memory.mean(dim=1), params["real_data_linear.weight"],
                    params["real_data_linear.bias"])

