"""Post-LayerNorm transformer layers with PyTorch ``nn.Transformer*`` semantics.

Parameter names follow the torch modules one to one (``self_attn.in_proj_weight``,
``self_attn.out_proj.weight``, ``linear1``, ``norm1`` ...), so the reference's
state dict and the converted JAX checkpoints load directly. The attention is
written out (scale q, additive float mask, boolean key-padding mask folded to
-inf, softmax, weighted sum) to follow the JAX package's ``models/layers.py``
step for step.

Compute dtype follows the activations, as flax's ``dtype=`` does: every
``Linear`` casts its weight and bias to the dtype of its input, attention
scores and the softmax stay in that dtype, and ``LayerNorm`` takes its
statistics in float32 and returns the input's dtype. Master weights stay
float32.

Dropout sits where flax has it (the attention weights after the softmax, each
sublayer's output, the feed-forward's hidden activation). It runs when the
module is in ``train()`` mode and the caller passes a dropout seed; each layer
draws its masks from a generator made from its own seed, so a layer
recomputed under ``checkpoint`` (``remat``) draws the same masks again.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def causal_mask(sz: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask: 0 on/below the diagonal, -inf above."""
    keep = torch.ones(sz, sz, dtype=torch.bool, device=device).tril()
    return torch.zeros(sz, sz, dtype=dtype, device=device).masked_fill(~keep, float("-inf"))


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax's Dropout: keep each element with probability 1 - p and divide the
    kept ones by 1 - p (in the dtype of ``x``); the identity when ``gen`` is
    None or ``p`` is 0."""
    if gen is None or p <= 0.0:
        return x
    keep_prob = 1.0 - p
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / torch.tensor(keep_prob, dtype=x.dtype), 0.0)


def make_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``; None for None."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class Linear(nn.Linear):
    """nn.Linear computing in the dtype of its input (flax's Dense with
    ``dtype=``): weight and bias are cast at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with its statistics and affine in float32 and the result
    in the input's dtype (flax's LayerNorm with ``dtype=``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention math, batch-first, with dropout on the
    attention weights."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        assert embed_dim % num_heads == 0, "embed_dim must be divisible by num_heads"
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(
        self,
        query: torch.Tensor,  # [B, Sq, D]
        key: torch.Tensor,  # [B, Sk, D]
        value: torch.Tensor,  # [B, Sk, D]
        attn_mask: Optional[torch.Tensor] = None,  # [Sq, Sk] additive float
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Sk] bool, True = masked
        gen: Optional[torch.Generator] = None,
        need_weights: bool = False,
    ):
        """-> the attention output [B, Sq, D]; with ``need_weights``, (output,
        the softmax weights [B, H, Sq, Sk] before dropout)."""
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
        weights = torch.softmax(scores, dim=-1)
        attn = dropout(weights, self.dropout, gen)
        out = self.out_proj((attn @ v).transpose(1, 2).reshape(B, Sq, d))
        return (out, weights) if need_weights else out


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
                 activation: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.p = dropout
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, ffn_dim)
        self.linear2 = Linear(ffn_dim, d_model)
        self.norm1 = LayerNorm(d_model, eps=eps)
        self.norm2 = LayerNorm(d_model, eps=eps)

    def forward(self, x, key_padding_mask=None, attn_mask=None, seed: Optional[int] = None):
        gen = make_generator(seed, x.device) if self.training else None
        sa = self.self_attn(x, x, x, attn_mask, key_padding_mask, gen)
        x = self.norm1(x + dropout(sa, self.p, gen))
        y = dropout(self.act(self.linear1(x)), self.p, gen)
        return self.norm2(x + dropout(self.linear2(y), self.p, gen))


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def init_like_flax(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from ``gen`` with flax's default
    initializer for its kind: xavier-uniform attention projections,
    lecun-normal (truncated) Linear weights, normal(1/sqrt(features))
    embeddings, zero biases, unit LayerNorm scales. Modules visited in
    ``named_modules`` order; other parameters are left as they are."""
    for name, mod in model.named_modules():
        if isinstance(mod, MultiheadAttention):
            nn.init.xavier_uniform_(mod.in_proj_weight, generator=gen)
            nn.init.xavier_uniform_(mod.out_proj.weight, generator=gen)
            mod.in_proj_bias.zero_()
            mod.out_proj.bias.zero_()
        elif isinstance(mod, nn.Linear) and not name.endswith("out_proj"):
            std = (1.0 / mod.in_features) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, std=mod.embedding_dim**-0.5, generator=gen)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model


def _run_layers(layers, x, args, seeds, remat: bool):
    """Apply ``layers`` in turn; with ``remat`` (and grad enabled) each layer
    is recomputed in the backward pass instead of keeping its activations."""
    for layer, seed in zip(layers, seeds or [None] * len(layers)):
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *args, seed, use_reentrant=False)
        else:
            x = layer(x, *args, seed)
    return x


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int = 2048,
                 eps: float = 1e-5, activation: str = "relu", dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, ffn_dim, eps, activation, dropout)
            for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None, attn_mask=None, seeds=None):
        """``seeds``: one dropout seed per layer (None: no dropout)."""
        return _run_layers(self.layers, x, (key_padding_mask, attn_mask), seeds, self.remat)


class TransformerDecoderLayer(nn.Module):
    """torch.nn.TransformerDecoderLayer, post-LN, ReLU feed-forward."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int = 2048, eps: float = 1e-5,
                 dropout: float = 0.0):
        super().__init__()
        self.p = dropout
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, ffn_dim)
        self.linear2 = Linear(ffn_dim, d_model)
        self.norm1 = LayerNorm(d_model, eps=eps)
        self.norm2 = LayerNorm(d_model, eps=eps)
        self.norm3 = LayerNorm(d_model, eps=eps)

    def forward(self, x, memory, tgt_mask=None, memory_key_padding_mask=None,
                seed: Optional[int] = None):
        gen = make_generator(seed, x.device) if self.training else None
        sa = self.self_attn(x, x, x, attn_mask=tgt_mask, gen=gen)
        x = self.norm1(x + dropout(sa, self.p, gen))
        ca = self.multihead_attn(x, memory, memory, key_padding_mask=memory_key_padding_mask,
                                 gen=gen)
        x = self.norm2(x + dropout(ca, self.p, gen))
        y = dropout(F.relu(self.linear1(x)), self.p, gen)
        return self.norm3(x + dropout(self.linear2(y), self.p, gen))


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int = 2048,
                 eps: float = 1e-5, dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, num_heads, ffn_dim, eps, dropout)
            for _ in range(num_layers)
        )

    def forward(self, x, memory, tgt_mask=None, memory_key_padding_mask=None, seeds=None):
        """``seeds``: one dropout seed per layer (None: no dropout)."""
        return _run_layers(self.layers, x, (memory, tgt_mask, memory_key_padding_mask), seeds,
                           self.remat)
