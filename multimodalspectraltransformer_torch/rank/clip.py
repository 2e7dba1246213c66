"""CLIP-style spectrum <-> SMILES contrastive ranking, inference.

Counterpart of the JAX package's ``rank/clip.py``: a Roberta-style text tower
(word + offset position + type embeddings, LayerNorm, a post-LN GELU
transformer, a tanh pooler over the first token), ``LL1`` to the CB
embedding, and two residual projection heads (Linear -> GELU -> Linear ->
+residual -> LayerNorm); the spectrum side projects the MMT's fingerprint.
Candidates are scored by the soft-target symmetric contrastive loss of their
block against the spectrum (``clip_loss``, ``score_candidates_batch``).

Parameter names follow the JAX tree (``models/convert.py::from_jax_clip_params``
maps a bundle onto them). Every LayerNorm is flax's: eps 1e-5, statistics in
float32 with the one-pass variance, the affine in float32, the result in the
input's dtype (``_layer_norm``).

``compute_dtype="bfloat16"`` reproduces what the JAX function computes when
it casts every float variable and the fingerprints to bfloat16 and lets flax
promote per module: the embedding sum and its LayerNorm run in bfloat16; every
encoder layer, the pooler, ``LL1`` and the CB head run in float32 on the
bfloat16-rounded weights; the MT head runs in bfloat16; both embeddings are
cast to float32 for the loss. Dropout is left out (inference only). The
tower's matmuls and attention are plain PyTorch: the JAX tower reaches no
Pallas kernel.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.convert import from_jax_clip_params, read_msgpack
from ..models.layers import TransformerEncoder, gelu_exact
from ..utils.device import DeviceLike, resolve_device

LN_EPS = 1e-5


@dataclass(frozen=True)
class CLIPConfig:
    # text tower (ChemBERTa-shape defaults; shrink for from-scratch training)
    text_vocab_size: int = 600
    text_hidden: int = 768
    text_layers: int = 6
    text_heads: int = 12
    text_ffn: int = 3072
    text_max_len: int = 128
    pad_token_id: int = 0
    # feature dims (reference config_V8: CB_embedding=1024, MT_embedding=512;
    # mt_embedding is the MT head's input width, the fingerprint's)
    cb_embedding: int = 1024
    mt_embedding: int = 512
    projection_dim: int = 512
    dropout: float = 0.1
    temperature: float = 1.0


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax's LayerNorm: mean and E[x^2] - mean^2 in float32, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias in float32, cast back to
    the dtype of ``x``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.float()
    return ((xf - mean) * mul + norm.bias.float()).to(x.dtype)


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax's Dense in the dtype of ``x``: the product, then the bias, each
    rounded to that dtype."""
    return x @ lin.weight.to(x.dtype).T + lin.bias.to(x.dtype)


class RobertaStyleEncoder(nn.Module):
    """Word + offset position + type embeddings -> LayerNorm -> post-LN GELU
    transformer -> tanh pooler over the first token."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.text_vocab_size, cfg.text_hidden)
        self.position_embeddings = nn.Embedding(cfg.text_max_len + 2, cfg.text_hidden)
        self.token_type_embedding = nn.Parameter(torch.zeros(cfg.text_hidden))
        self.emb_norm = nn.LayerNorm(cfg.text_hidden, eps=LN_EPS)
        self.encoder = TransformerEncoder(cfg.text_layers, cfg.text_hidden, cfg.text_heads,
                                          cfg.text_ffn, LN_EPS, "gelu")
        self.pooler = nn.Linear(cfg.text_hidden, cfg.text_hidden)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                emb_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, T] ids and mask (1 = real token) -> [B, hidden] float32;
        ``emb_dtype``: the dtype of the embedding sum and its LayerNorm."""
        # Roberta position ids: cumsum over the mask plus the pad-token offset
        positions = torch.cumsum(attention_mask, dim=1) * attention_mask + self.cfg.pad_token_id
        word = self.word_embeddings.weight.to(emb_dtype)[tokens.long()]
        pos = self.position_embeddings.weight.to(emb_dtype)[positions.long()]
        x = word + pos + self.token_type_embedding.to(emb_dtype)
        x = _layer_norm(x, self.emb_norm).float()
        x = self.encoder(x, attention_mask == 0)
        return torch.tanh(self.pooler(x[:, 0, :]))


class ProjectionHead(nn.Module):
    """Linear -> exact GELU -> Linear -> +residual -> LayerNorm, in the dtype
    of its input."""

    def __init__(self, in_dim: int, projection_dim: int):
        super().__init__()
        self.projection = nn.Linear(in_dim, projection_dim)
        self.fc = nn.Linear(projection_dim, projection_dim)
        self.layer_norm = nn.LayerNorm(projection_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = _dense(x, self.projection)
        y = _dense(gelu_exact(projected), self.fc)
        return _layer_norm(y + projected, self.layer_norm)


class CLIPRanker(nn.Module):
    """Text tower + LL1 + both projection heads. The spectrum side takes the
    MMT fingerprint computed outside, so the two models load separately."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = RobertaStyleEncoder(cfg)
        self.LL1 = nn.Linear(cfg.text_hidden, cfg.cb_embedding)
        self.CB_projection = ProjectionHead(cfg.cb_embedding, cfg.projection_dim)
        self.MT_projection = ProjectionHead(cfg.mt_embedding, cfg.projection_dim)

    def embed_text(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                   emb_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        pooled = self.text_encoder(tokens, attention_mask, emb_dtype)
        return self.CB_projection(_dense(pooled, self.LL1))

    def embed_spectrum(self, fingerprint: torch.Tensor) -> torch.Tensor:
        return self.MT_projection(fingerprint)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                fingerprint: torch.Tensor, emb_dtype: torch.dtype = torch.float32):
        return self.embed_text(tokens, attention_mask, emb_dtype), self.embed_spectrum(fingerprint)


class CLIPLossOutput(NamedTuple):
    mean_loss: torch.Tensor
    per_sample_loss: torch.Tensor  # [..., B]
    logits: torch.Tensor  # [..., B, B]


def _soft_cross_entropy(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.sum(-targets * F.log_softmax(preds, dim=-1), dim=-1)


def clip_loss(cb_emb: torch.Tensor, mt_emb: torch.Tensor, temperature: float = 1.0
              ) -> CLIPLossOutput:
    """Soft-target symmetric contrastive loss over [..., B, D] blocks (the
    reference both divides the logits and multiplies the targets by the
    temperature)."""
    logits = (cb_emb @ mt_emb.transpose(-1, -2)) / temperature
    mt_sim = mt_emb @ mt_emb.transpose(-1, -2)
    cb_sim = cb_emb @ cb_emb.transpose(-1, -2)
    targets = torch.softmax((mt_sim + cb_sim) / 2 * temperature, dim=-1)
    texts_loss = _soft_cross_entropy(logits, targets)
    images_loss = _soft_cross_entropy(logits.transpose(-1, -2), targets.transpose(-1, -2))
    per_sample = (texts_loss + images_loss) / 2.0
    return CLIPLossOutput(per_sample.mean(dim=-1), per_sample, logits)


class ScoreOutput(NamedTuple):
    losses: torch.Tensor  # [..., C] per-candidate CLIP loss
    dot_similarity: torch.Tensor  # [..., C] candidate text . spectrum embedding
    logits: torch.Tensor  # [..., C, C]


def _scored(cb: torch.Tensor, mt: torch.Tensor, temperature: float) -> ScoreOutput:
    out = clip_loss(cb, mt, temperature)
    # all spectrum rows of a block are the same: column 0 is the candidate's dot
    dot = (cb @ mt.transpose(-1, -2))[..., 0]
    return ScoreOutput(out.per_sample_loss, dot, out.logits)


@torch.no_grad()
def score_candidates(model: CLIPRanker, cfg: CLIPConfig, cand_tokens: torch.Tensor,
                     cand_mask: torch.Tensor, fingerprint: torch.Tensor) -> ScoreOutput:
    """One molecule: [C, T] candidate ids and mask, the fingerprint [F] (or
    [C, F], rows alike) -> per-candidate losses and dot similarities."""
    if fingerprint.dim() == 1:
        fingerprint = fingerprint[None, :].expand(cand_tokens.shape[0], -1)
    cb, mt = model(cand_tokens, cand_mask, fingerprint)
    return _scored(cb, mt, cfg.temperature)


@torch.no_grad()
def score_candidates_batch(model: CLIPRanker, cfg: CLIPConfig, cand_tokens: torch.Tensor,
                           cand_mask: torch.Tensor, fingerprints: torch.Tensor,
                           compute_dtype: Optional[str] = None) -> ScoreOutput:
    """``score_candidates`` for M molecules in one pass: [M, C, T] ids and
    masks and [M, F] fingerprints -> fields [M, C] (logits [M, C, C]). All
    M * C candidates go through the text tower as one batch; each molecule
    keeps its own C x C block. Each fingerprint is projected once and its
    embedding tiled over the block, as the JAX function does.
    ``compute_dtype="bfloat16"``: the module docstring's mixed precision."""
    M, C, T = cand_tokens.shape
    params = dict(model.named_parameters())
    emb_dtype = torch.float32
    if compute_dtype == "bfloat16":
        # bfloat16-rounded weights held in float32: exact in either dtype
        params = {k: v.to(torch.bfloat16).float() for k, v in params.items()}
        fingerprints = fingerprints.to(torch.bfloat16)
        emb_dtype = torch.bfloat16
    elif compute_dtype is not None:
        raise ValueError(f"compute_dtype must be None or 'bfloat16', got {compute_dtype!r}")
    cb, mt_unique = functional_call(
        model, params, (cand_tokens.reshape(M * C, T), cand_mask.reshape(M * C, T), fingerprints),
        {"emb_dtype": emb_dtype})
    cb = cb.reshape(M, C, -1).float()
    mt = mt_unique.float()[:, None, :].expand(M, C, -1)
    return _scored(cb, mt, cfg.temperature)


def load_bundle(path: str, device: DeviceLike = None) -> tuple[CLIPRanker, CLIPConfig]:
    """A CLIP bundle (``<path>``, the flax msgpack of the variables, ``.gz``
    or not, and ``<path without .gz>.json``, the CLIPConfig) -> an eval-mode
    ``CLIPRanker`` on ``device`` (cuda unless asked otherwise) and its
    config: the ``clip_bundle`` argument of ``eval.harness.evaluate_molecules``."""
    dev = resolve_device(device)
    base = path[:-3] if path.endswith(".gz") else path
    with open(base + ".json") as f:
        cfg = CLIPConfig(**json.load(f))
    model = CLIPRanker(cfg)
    model.load_state_dict(from_jax_clip_params(read_msgpack(path)))
    return model.eval().to(dev), cfg
