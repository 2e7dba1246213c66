"""Post-LayerNorm transformer layers with PyTorch ``nn.Transformer*`` semantics.

Parameter names follow the torch modules one to one (``self_attn.in_proj_weight``,
``self_attn.out_proj.weight``, ``linear1``, ``norm1`` ...), so the reference's
state dict and the converted JAX checkpoints load directly. The attention is
written out (scale q, additive float mask, boolean key-padding mask folded to
-inf, softmax, weighted sum) to follow the JAX package's ``models/layers.py``
step for step; dropout is left out because the port runs inference only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def causal_mask(sz: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    keep = torch.ones(sz, sz, dtype=torch.bool, device=device).tril()
    return torch.zeros(sz, sz, dtype=dtype, device=device).masked_fill(~keep, float("-inf"))


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention math, batch-first, inference only."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        assert embed_dim % num_heads == 0, "embed_dim must be divisible by num_heads"
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(
        self,
        query: torch.Tensor,  # [B, Sq, D]
        key: torch.Tensor,  # [B, Sk, D]
        value: torch.Tensor,  # [B, Sk, D]
        attn_mask: Optional[torch.Tensor] = None,  # [Sq, Sk] additive float
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Sk] bool, True = masked
    ) -> torch.Tensor:
        d, h = self.embed_dim, self.num_heads
        dh = d // h
        w, b = self.in_proj_weight.to(query.dtype), self.in_proj_bias.to(query.dtype)
        if query is key and key is value:
            q, k, v = F.linear(query, w, b).chunk(3, dim=-1)
        else:
            q = F.linear(query, w[:d], b[:d])
            k = F.linear(key, w[d : 2 * d], b[d : 2 * d])
            v = F.linear(value, w[2 * d :], b[2 * d :])
        B, Sq, _ = q.shape
        Sk = k.shape[1]
        q = q.reshape(B, Sq, h, dh).transpose(1, 2)
        k = k.reshape(B, Sk, h, dh).transpose(1, 2)
        v = v.reshape(B, Sk, h, dh).transpose(1, 2)
        q = q / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(q.dtype)
        scores = q @ k.transpose(-1, -2)  # [B, H, Sq, Sk]
        if attn_mask is not None:
            scores = scores + attn_mask.to(scores.dtype)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        attn = torch.softmax(scores, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, Sq, d)
        return self.out_proj(out)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU in the JAX package's form, x/2 * erfc(-x/sqrt(2)),
    each step in the dtype of ``x``."""
    return 0.5 * x * torch.erfc(-x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))


ACTIVATIONS = {"relu": F.relu, "gelu": gelu_exact}


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer, post-LN; ``activation`` is the
    feed-forward's: "relu" (torch's default, the MMT) or "gelu" (the exact
    erf form of the Roberta-style CLIP text tower)."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int = 2048, eps: float = 1e-5,
                 activation: str = "relu"):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=eps)
        self.norm2 = nn.LayerNorm(d_model, eps=eps)

    def forward(self, x, key_padding_mask=None, attn_mask=None):
        x = self.norm1(x + self.self_attn(x, x, x, attn_mask, key_padding_mask))
        return self.norm2(x + self.linear2(self.act(self.linear1(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int = 2048,
                 eps: float = 1e-5, activation: str = "relu"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, ffn_dim, eps, activation)
            for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None, attn_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask, attn_mask)
        return x


class TransformerDecoderLayer(nn.Module):
    """torch.nn.TransformerDecoderLayer, post-LN, ReLU feed-forward."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int = 2048, eps: float = 1e-5):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.multihead_attn = MultiheadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=eps)
        self.norm2 = nn.LayerNorm(d_model, eps=eps)
        self.norm3 = nn.LayerNorm(d_model, eps=eps)

    def forward(self, x, memory, tgt_mask=None, memory_key_padding_mask=None):
        x = self.norm1(x + self.self_attn(x, x, x, attn_mask=tgt_mask))
        x = self.norm2(x + self.multihead_attn(x, memory, memory,
                                               key_padding_mask=memory_key_padding_mask))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int = 2048,
                 eps: float = 1e-5):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, num_heads, ffn_dim, eps) for _ in range(num_layers)
        )

    def forward(self, x, memory, tgt_mask=None, memory_key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, memory, tgt_mask, memory_key_padding_mask)
        return x
