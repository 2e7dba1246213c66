"""The Multimodal Spectral Transformer (MMT) as a PyTorch module.

Five per-modality transformer encoders (1H, 13C, HSQC, COSY, IR), each over a
``[spectrum | MF | (MS) | MW]`` token sequence, a cross-modal fusion encoder
over the concatenated memories, a fingerprint head mean-pooled over every
position (padding included), and an autoregressive SMILES decoder with learned
positional embeddings. Same math as the JAX package's ``models/mmt.py``:

- inactive modalities contribute zero-memory blocks: NMR blanks fully
  masked, the COSY blank 65 tokens long under ``parity_cosy_blank_65``, and
  the IR blank attended zeros;
- the IR encoder sequence is 66 tokens; the IR spectrum token is always
  attended;
- ``use_real_data`` averages the logits with ``real_data_linear`` of the
  mean memory.

Submodule names are the reference torch model's, so ``load_state_dict`` takes
the output of ``convert.from_jax_params`` directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.config import ModelConfig
from ..utils.device import DeviceLike, resolve_device
from .convert import ENCODER_TORCH_PREFIXES, SPEC_EMBED_TORCH_KEYS, from_jax_params, read_msgpack
from .layers import (Linear, TransformerDecoder, TransformerEncoder, causal_mask, dropout,
                     init_like_flax, make_generator)

MODALITY_ORDER: tuple[str, ...] = ("1H", "13C", "HSQC", "COSY", "IR")


class MMTBatch(NamedTuple):
    """One batch of model inputs (numpy or torch). Masks: 1/True = padding."""

    src_1h: object  # [B, P, 2]
    mask_1h: object  # [B, P]
    src_13c: object  # [B, P]
    mask_13c: object  # [B, P]
    src_hsqc: object  # [B, P, 2]
    mask_hsqc: object  # [B, P]
    src_cosy: object  # [B, P, 2]
    mask_cosy: object  # [B, P]
    src_ir: object  # [B, ir_bins]
    src_mf: object  # [B, mf_len] int ids
    mask_mf: object  # [B, mf_len]
    src_ms: object  # [B, ms_len] int ids
    mask_ms: object  # [B, ms_len]
    mw: object  # [B]

    def to(self, device) -> "MMTBatch":
        return MMTBatch(*(torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
                          .to(device) for x in self))


def dummy_batch(cfg: ModelConfig, batch_size: int = 2, device: DeviceLike = None) -> MMTBatch:
    """An all-zeros batch of the model's input shapes on ``device`` (cuda
    unless asked otherwise); every position attended."""
    dev = resolve_device(device)
    P = cfg.spectrum_points
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    return MMTBatch(
        src_1h=z(batch_size, P, 2), mask_1h=zi(batch_size, P),
        src_13c=z(batch_size, P), mask_13c=zi(batch_size, P),
        src_hsqc=z(batch_size, P, 2), mask_hsqc=zi(batch_size, P),
        src_cosy=z(batch_size, P, 2), mask_cosy=zi(batch_size, P),
        src_ir=z(batch_size, cfg.ir_bins),
        src_mf=zi(batch_size, cfg.mf_len), mask_mf=zi(batch_size, cfg.mf_len),
        src_ms=zi(batch_size, cfg.ms_len), mask_ms=zi(batch_size, cfg.ms_len),
        mw=z(batch_size),
    )


class EncoderOutput(NamedTuple):
    memory: torch.Tensor  # [B, S_fused, D]
    memory_key_padding_mask: torch.Tensor  # [B, S_fused] bool, True = masked
    fingerprint: torch.Tensor  # [B, fingerprint_size]


def _nested(root: nn.Module, dotted: str, module: nn.Module) -> nn.Module:
    """Register ``module`` under a dotted path of plain holder modules."""
    *parents, leaf = dotted.split(".")
    node = root
    for name in parents:
        if not hasattr(node, name):
            node.add_module(name, nn.Module())
        node = getattr(node, name)
    node.add_module(leaf, module)
    return module


class _Embedding(nn.Module):
    """Holder giving the reference key ``<name>.embedding.weight``."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.embedding = nn.Embedding(n, d)


class MultimodalTransformer(nn.Module):
    """Five modality encoders + fusion encoder + SMILES decoder.

    ``forward`` is the training pass (the JAX module's ``__call__``), with
    gradients; ``encode`` and ``decode`` are its halves for inference, without.
    Each takes a compute ``dtype`` (default ``cfg.dtype``): under bfloat16 the
    inputs, every Linear and Embedding (weights cast at use), the attention and
    the outputs are bfloat16, as in flax's ``dtype=bfloat16``; the parameters
    stay float32. Dropout (``cfg.dropout``) runs in ``train()`` mode when a
    ``generator`` is passed: one seed per layer (and one for the target
    embedding) is drawn from it, so every modality encoder gets its own masks.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        in_dims = {"embed_1h": 2, "embed_13c": 1, "embed_hsqc": 2, "embed_cosy": 2,
                   "embed_ir": cfg.ir_bins, "embed_mw": 1}
        self.spec_embed = {k: _nested(self, v, Linear(in_dims[k], d))
                           for k, v in SPEC_EMBED_TORCH_KEYS.items()}
        self.linear_embedding_MF = _Embedding(cfg.mf_vocab_size + 1, d)
        self.linear_embedding_MS = _Embedding(cfg.smiles_vocab_size, d)
        self.embed_trg = nn.Embedding(cfg.smiles_vocab_size, d)
        self.pe_trg = nn.Embedding(cfg.max_len, d)
        enc = lambda heads: TransformerEncoder(cfg.num_encoder_layers, d, heads, cfg.ffn_dim,
                                               cfg.layer_norm_eps, dropout=cfg.dropout,
                                               remat=cfg.remat)
        for prefix in ENCODER_TORCH_PREFIXES:
            self.add_module(prefix, enc(cfg.num_heads))
        self.encoder_cross = enc(cfg.cross_num_heads)
        self.decoder = TransformerDecoder(cfg.num_decoder_layers, d, cfg.num_heads, cfg.ffn_dim,
                                          cfg.layer_norm_eps, dropout=cfg.dropout,
                                          remat=cfg.remat)
        self.fp1 = Linear(d, cfg.fingerprint_size)
        self.fc_out = Linear(d, cfg.smiles_vocab_size)
        self.real_data_linear = Linear(d, cfg.smiles_vocab_size)

    def _dtype(self, dtype) -> torch.dtype:
        """A torch dtype from ``dtype`` (a dtype or its name; None: cfg.dtype)."""
        if isinstance(dtype, torch.dtype):
            return dtype
        return getattr(torch, dtype or self.cfg.dtype)

    def _seeds(self, generator: Optional[torch.Generator], n: int) -> Optional[list[int]]:
        """``n`` dropout seeds from ``generator`` in train mode, else None."""
        if generator is None or not self.training or self.cfg.dropout <= 0.0:
            return None
        return torch.randint(0, 2**62, (n,), generator=generator,
                             device=generator.device).tolist()

    # ---------------------------------------------------------------- encoder

    def _cond_embeddings(self, batch: MMTBatch, dt: torch.dtype):
        """[MF | MS | MW] conditioning suffix -> (emb [B, c, D], mask [B, c])."""
        cfg = self.cfg
        B = batch.mw.shape[0]
        dev = batch.mw.device
        embs, masks = [], []
        if cfg.modalities.use_mf:
            embs.append(F.relu(_embed(self.linear_embedding_MF.embedding, batch.src_mf, dt)))
            masks.append(batch.mask_mf.bool())
        if cfg.modalities.use_ms:
            embs.append(F.relu(_embed(self.linear_embedding_MS.embedding, batch.src_ms, dt)))
            masks.append(batch.mask_ms.bool())
        if cfg.modalities.use_mw:
            mw = batch.mw.to(dt)[:, None, None]
            embs.append(F.relu(self.spec_embed["embed_mw"](mw)))
            masks.append(torch.zeros(B, 1, dtype=torch.bool, device=dev))
        if not embs:
            return (torch.zeros(B, 0, cfg.hidden_size, dtype=dt, device=dev),
                    torch.zeros(B, 0, dtype=torch.bool, device=dev))
        return torch.cat(embs, dim=1), torch.cat(masks, dim=1)

    def _encode(self, batch: MMTBatch, generator, dtype) -> EncoderOutput:
        cfg = self.cfg
        dt = self._dtype(dtype)
        B = batch.mw.shape[0]
        D = cfg.hidden_size
        L = cfg.nmr_seq_len
        dev = batch.mw.device
        n_layers = cfg.num_encoder_layers
        seeds = self._seeds(generator, 6 * n_layers)
        cond_emb, cond_mask = self._cond_embeddings(batch, dt)
        emb = self.spec_embed
        specs = {
            "1H": (F.relu(emb["embed_1h"](batch.src_1h.to(dt))), batch.mask_1h),
            "13C": (F.relu(emb["embed_13c"](batch.src_13c.to(dt)[..., None])), batch.mask_13c),
            "HSQC": (F.relu(emb["embed_hsqc"](batch.src_hsqc.to(dt))), batch.mask_hsqc),
            "COSY": (F.relu(emb["embed_cosy"](batch.src_cosy.to(dt))), batch.mask_cosy),
            # the IR token is always attended
            "IR": (F.relu(emb["embed_ir"](batch.src_ir.to(dt)))[:, None, :],
                   torch.zeros(B, 1, dtype=torch.bool, device=dev)),
        }
        active = dict(zip(MODALITY_ORDER, (cfg.modalities.use_1h, cfg.modalities.use_13c,
                                           cfg.modalities.use_hsqc, cfg.modalities.use_cosy,
                                           cfg.modalities.use_ir)))
        pieces, masks = [], []
        for m, (name, prefix) in enumerate(zip(MODALITY_ORDER, ENCODER_TORCH_PREFIXES)):
            if active[name]:
                e, mk = specs[name]
                x = torch.cat([e, cond_emb], dim=1)
                mk = torch.cat([mk.bool(), cond_mask], dim=1)
                # the JAX package pads every lane to L for its stacked
                # encoder; masked padding is inert, so run at true length
                lane_seeds = seeds and seeds[m * n_layers : (m + 1) * n_layers]
                pieces.append(getattr(self, prefix)(x, mk, seeds=lane_seeds))
                masks.append(mk)
            else:
                if name == "IR":
                    bl, blank_mask = cfg.ir_seq_len, False  # attended zeros
                elif name == "COSY":
                    bl, blank_mask = cfg.cosy_blank_len, True
                else:
                    bl, blank_mask = L, True
                pieces.append(torch.zeros(B, bl, D, dtype=dt, device=dev))
                masks.append(torch.full((B, bl), blank_mask, dtype=torch.bool, device=dev))
        fused = torch.cat(pieces, dim=1)
        fused_mask = torch.cat(masks, dim=1)
        memory = self.encoder_cross(fused, fused_mask, seeds=seeds and seeds[5 * n_layers :])
        # mean over the whole sequence, padded positions included
        fingerprint = self.fp1(memory.mean(dim=1))
        return EncoderOutput(memory, fused_mask, fingerprint)

    # ---------------------------------------------------------------- decoder

    def decode_train(self, trg_tokens: torch.Tensor, memory: torch.Tensor,
                     memory_key_padding_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None, dtype=None) -> torch.Tensor:
        """Teacher-forced decoder pass with gradients -> logits [B, T, vocab]
        (in the compute dtype)."""
        dt = self._dtype(dtype)
        seeds = self._seeds(generator, self.cfg.num_decoder_layers + 1)
        T = trg_tokens.shape[1]
        dev = trg_tokens.device
        pos = torch.arange(T, device=dev)
        x = _embed(self.embed_trg, trg_tokens, dt) + _embed(self.pe_trg, pos, dt)[None]
        x = dropout(x, self.cfg.dropout, make_generator(seeds and seeds[-1], dev))
        mask = causal_mask(T, dtype=dt, device=dev)
        dec = self.decoder(x, memory, mask, memory_key_padding_mask, seeds=seeds and seeds[:-1])
        logits = self.fc_out(dec)
        if self.cfg.use_real_data:
            blend = self.real_data_linear(memory.mean(dim=1))
            logits = (logits + blend[:, None, :]) / 2
        return logits

    def forward(self, batch: MMTBatch, trg_tokens: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dtype=None):
        """The training pass: ``encode`` then, given ``trg_tokens``, the
        teacher-forced decode -> (logits, fingerprint, memory, mask); without
        ``trg_tokens`` the ``EncoderOutput``. Separate generators for the two
        halves are drawn from ``generator``."""
        enc_gen, dec_gen = split_generator(generator, 2)
        enc = self._encode(batch, enc_gen, dtype)
        if trg_tokens is None:
            return enc
        logits = self.decode_train(trg_tokens, enc.memory, enc.memory_key_padding_mask, dec_gen,
                                   dtype)
        return logits, enc.fingerprint, enc.memory, enc.memory_key_padding_mask

    @torch.no_grad()
    def encode(self, batch: MMTBatch, dtype=None) -> EncoderOutput:
        """Per-modality encoders + fusion encoder, for inference."""
        return self._encode(batch, None, dtype)

    @torch.no_grad()
    def decode(self, trg_tokens: torch.Tensor, memory: torch.Tensor,
               memory_key_padding_mask: torch.Tensor, dtype=None) -> torch.Tensor:
        """Teacher-forced decoder pass -> logits [B, T, vocab], for inference."""
        return self.decode_train(trg_tokens, memory, memory_key_padding_mask, None, dtype)


def split_generator(generator: Optional[torch.Generator], n: int) -> list[Optional[torch.Generator]]:
    """``n`` independent CPU generators seeded from ``generator`` (all None
    for None): the counterpart of ``jax.random.split``."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def _embed(table: nn.Embedding, ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax's Embed with ``dtype=``: the table cast to ``dt``, then the rows."""
    return F.embedding(ids.long(), table.weight.to(dt))


@torch.no_grad()
def init_model(cfg: ModelConfig = ModelConfig(), seed: int = 0, device: DeviceLike = None
               ) -> MultimodalTransformer:
    """A from-scratch model on ``device`` (cuda unless asked otherwise) with
    the JAX package's initializer for each leaf (``layers.init_like_flax``).
    Drawn on the CPU from ``seed``, so every device gets the same weights."""
    dev = resolve_device(device)
    model = MultimodalTransformer(cfg)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def model_from_state_dict(state_dict: dict, cfg: ModelConfig = ModelConfig(),
                          device: DeviceLike = None) -> MultimodalTransformer:
    """An eval-mode model on ``device`` (cuda unless asked otherwise) holding a
    copy of ``state_dict``."""
    dev = resolve_device(device)
    model = MultimodalTransformer(cfg)
    model.load_state_dict(state_dict)
    return model.eval().to(dev)


def load_model(path: str, cfg: ModelConfig = ModelConfig(), device: DeviceLike = None
               ) -> MultimodalTransformer:
    """A committed flax msgpack checkpoint -> an eval-mode model on ``device``
    (cuda unless asked otherwise)."""
    return model_from_state_dict(from_jax_params(read_msgpack(path)), cfg, device)
