"""CLIP-style spectrum <-> SMILES contrastive ranking.

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
cast to float32 for the loss. The tower's matmuls and attention are plain
PyTorch: the JAX tower reaches no Pallas kernel.

Training (``train/contrastive.py``): dropout (``cfg.dropout``) sits where
flax has it (after the embedding LayerNorm, in every encoder layer, in each
projection head before its residual) and runs only in ``train()`` mode when
a ``generator`` is passed; one seed per dropout site is drawn from it, as
the MMT does. ``from_hf_roberta`` and ``from_torch_clip`` map HuggingFace
Roberta (ChemBERTa) and reference CLIPModel state dicts onto the port's
keys; ``save_bundle`` writes the bundle that ``load_bundle`` (and the JAX
package's) reads.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.convert import from_jax_clip_params, read_msgpack, to_jax_clip_params, write_msgpack
from ..models.layers import TransformerEncoder, dropout, gelu_exact, make_generator
from ..ops.embedding_grad import embedding_lookup
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


def dropout_seeds(module: nn.Module, p: float, generator: Optional[torch.Generator],
                  n: int) -> list[Optional[int]]:
    """``n`` dropout seeds drawn from ``generator`` when ``module`` is in
    train mode with a rate above 0; else ``n`` Nones (no dropout)."""
    if generator is None or not module.training or p <= 0.0:
        return [None] * n
    return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()


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
                                          cfg.text_ffn, LN_EPS, "gelu", cfg.dropout)
        self.pooler = nn.Linear(cfg.text_hidden, cfg.text_hidden)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                emb_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] ids and mask (1 = real token) -> [B, hidden] float32;
        ``emb_dtype``: the dtype of the embedding sum and its LayerNorm;
        ``generator``: dropout's seeds (train mode only)."""
        seeds = dropout_seeds(self, self.cfg.dropout, generator, 1 + self.cfg.text_layers)
        # Roberta position ids: cumsum over the mask plus the pad-token offset
        positions = torch.cumsum(attention_mask, dim=1) * attention_mask + self.cfg.pad_token_id
        word = embedding_lookup(self.word_embeddings.weight.to(emb_dtype), tokens)
        pos = embedding_lookup(self.position_embeddings.weight.to(emb_dtype), positions)
        x = word + pos + self.token_type_embedding.to(emb_dtype)
        x = _layer_norm(x, self.emb_norm)
        x = dropout(x, self.cfg.dropout, make_generator(seeds[0], x.device)).float()
        x = self.encoder(x, attention_mask == 0, seeds=seeds[1:])
        return torch.tanh(self.pooler(x[:, 0, :]))


class ProjectionHead(nn.Module):
    """Linear -> exact GELU -> Linear -> dropout -> +residual -> LayerNorm, in
    the dtype of its input."""

    def __init__(self, in_dim: int, projection_dim: int, p: float = 0.1):
        super().__init__()
        self.p = p
        self.projection = nn.Linear(in_dim, projection_dim)
        self.fc = nn.Linear(projection_dim, projection_dim)
        self.layer_norm = nn.LayerNorm(projection_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """``seed``: this head's dropout seed (None: no dropout)."""
        projected = _dense(x, self.projection)
        y = _dense(gelu_exact(projected), self.fc)
        y = dropout(y, self.p, make_generator(seed, x.device) if self.training else None)
        return _layer_norm(y + projected, self.layer_norm)


class CLIPRanker(nn.Module):
    """Text tower + LL1 + both projection heads. The spectrum side takes the
    MMT fingerprint computed outside, so the two models load separately."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = RobertaStyleEncoder(cfg)
        self.LL1 = nn.Linear(cfg.text_hidden, cfg.cb_embedding)
        self.CB_projection = ProjectionHead(cfg.cb_embedding, cfg.projection_dim, cfg.dropout)
        self.MT_projection = ProjectionHead(cfg.mt_embedding, cfg.projection_dim, cfg.dropout)

    def embed_text(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                   emb_dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pooled = self.text_encoder(tokens, attention_mask, emb_dtype, generator)
        (seed,) = dropout_seeds(self, self.cfg.dropout, generator, 1)
        return self.CB_projection(_dense(pooled, self.LL1), seed)

    def embed_spectrum(self, fingerprint: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        (seed,) = dropout_seeds(self, self.cfg.dropout, generator, 1)
        return self.MT_projection(fingerprint, seed)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                fingerprint: torch.Tensor, emb_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None):
        """-> (text embeddings, spectrum embeddings); ``generator``: dropout
        (train mode only)."""
        return (self.embed_text(tokens, attention_mask, emb_dtype, generator),
                self.embed_spectrum(fingerprint, generator))


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


def save_bundle(path: str, model: CLIPRanker, cfg: CLIPConfig) -> None:
    """Write ``<path>`` (the flax msgpack of ``{"params": ...}``, gzipped
    for ``.gz``) and ``<path without .gz>.json`` (the CLIPConfig fields):
    the bundle ``load_bundle`` and the JAX package's ``load_bundle`` read."""
    write_msgpack(to_jax_clip_params(model.state_dict()), path)
    base = path[:-3] if path.endswith(".gz") else path
    with open(base + ".json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)


# ---------------------------------------------------------------------------
# HuggingFace Roberta (ChemBERTa) and reference CLIPModel state dicts
# ---------------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    """A state-dict entry (torch tensor or array) as a float32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).cpu().contiguous()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def from_hf_roberta(cfg: CLIPConfig, hf_state: Mapping) -> dict[str, torch.Tensor]:
    """A ``transformers.RobertaModel`` state dict -> the state dict of
    ``RobertaStyleEncoder``: the separate query/key/value projections are
    concatenated into ``in_proj``; the first token-type row is the type
    embedding."""
    t = lambda key: _f32(hf_state[key])
    sd = {
        "word_embeddings.weight": t("embeddings.word_embeddings.weight"),
        "position_embeddings.weight": t("embeddings.position_embeddings.weight"),
        "token_type_embedding": t("embeddings.token_type_embeddings.weight")[0].clone(),
        "emb_norm.weight": t("embeddings.LayerNorm.weight"),
        "emb_norm.bias": t("embeddings.LayerNorm.bias"),
        "pooler.weight": t("pooler.dense.weight"),
        "pooler.bias": t("pooler.dense.bias"),
    }
    for i in range(cfg.text_layers):
        pre, ours = f"encoder.layer.{i}", f"encoder.layers.{i}"
        att = f"{pre}.attention.self"
        sd[f"{ours}.self_attn.in_proj_weight"] = torch.cat(
            [t(f"{att}.{x}.weight") for x in ("query", "key", "value")])
        sd[f"{ours}.self_attn.in_proj_bias"] = torch.cat(
            [t(f"{att}.{x}.bias") for x in ("query", "key", "value")])
        for theirs, mine in (("attention.output.dense", "self_attn.out_proj"),
                             ("attention.output.LayerNorm", "norm1"),
                             ("intermediate.dense", "linear1"), ("output.dense", "linear2"),
                             ("output.LayerNorm", "norm2")):
            sd[f"{ours}.{mine}.weight"] = t(f"{pre}.{theirs}.weight")
            sd[f"{ours}.{mine}.bias"] = t(f"{pre}.{theirs}.bias")
    return sd


def from_torch_clip(cfg: CLIPConfig, sd: Mapping) -> dict[str, torch.Tensor]:
    """A saved reference CLIPModel state dict (``CB_model.chemberta`` the
    RobertaModel, ``CB_model.LL1``, ``CB_projection``, ``MT_projection``) ->
    the state dict of ``CLIPRanker``."""
    prefix = "CB_model.chemberta."
    out = {f"text_encoder.{k}": v for k, v in from_hf_roberta(
        cfg, {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}).items()}
    out["LL1.weight"] = _f32(sd["CB_model.LL1.weight"])
    out["LL1.bias"] = _f32(sd["CB_model.LL1.bias"])
    for head in ("CB_projection", "MT_projection"):
        for part in ("projection", "fc", "layer_norm"):
            for leaf in ("weight", "bias"):
                out[f"{head}.{part}.{leaf}"] = _f32(sd[f"{head}.{part}.{leaf}"])
    return out
