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

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.config import ModelConfig
from ..utils.device import DeviceLike, resolve_device
from .convert import ENCODER_TORCH_PREFIXES, SPEC_EMBED_TORCH_KEYS, from_jax_params, read_msgpack
from .layers import TransformerDecoder, TransformerEncoder, causal_mask

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
    """Five modality encoders + fusion encoder + SMILES decoder."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        in_dims = {"embed_1h": 2, "embed_13c": 1, "embed_hsqc": 2, "embed_cosy": 2,
                   "embed_ir": cfg.ir_bins, "embed_mw": 1}
        self.spec_embed = {k: _nested(self, v, nn.Linear(in_dims[k], d))
                           for k, v in SPEC_EMBED_TORCH_KEYS.items()}
        self.linear_embedding_MF = _Embedding(cfg.mf_vocab_size + 1, d)
        self.linear_embedding_MS = _Embedding(cfg.smiles_vocab_size, d)
        self.embed_trg = nn.Embedding(cfg.smiles_vocab_size, d)
        self.pe_trg = nn.Embedding(cfg.max_len, d)
        enc = lambda heads: TransformerEncoder(cfg.num_encoder_layers, d, heads, cfg.ffn_dim,
                                               cfg.layer_norm_eps)
        for prefix in ENCODER_TORCH_PREFIXES:
            self.add_module(prefix, enc(cfg.num_heads))
        self.encoder_cross = enc(cfg.cross_num_heads)
        self.decoder = TransformerDecoder(cfg.num_decoder_layers, d, cfg.num_heads, cfg.ffn_dim,
                                          cfg.layer_norm_eps)
        self.fp1 = nn.Linear(d, cfg.fingerprint_size)
        self.fc_out = nn.Linear(d, cfg.smiles_vocab_size)
        self.real_data_linear = nn.Linear(d, cfg.smiles_vocab_size)

    # ---------------------------------------------------------------- encoder

    def _cond_embeddings(self, batch: MMTBatch):
        """[MF | MS | MW] conditioning suffix -> (emb [B, c, D], mask [B, c])."""
        cfg = self.cfg
        B = batch.mw.shape[0]
        dev = batch.mw.device
        embs, masks = [], []
        if cfg.modalities.use_mf:
            embs.append(F.relu(self.linear_embedding_MF.embedding(batch.src_mf.long())))
            masks.append(batch.mask_mf.bool())
        if cfg.modalities.use_ms:
            embs.append(F.relu(self.linear_embedding_MS.embedding(batch.src_ms.long())))
            masks.append(batch.mask_ms.bool())
        if cfg.modalities.use_mw:
            mw = batch.mw.float()[:, None, None]
            embs.append(F.relu(self.spec_embed["embed_mw"](mw)))
            masks.append(torch.zeros(B, 1, dtype=torch.bool, device=dev))
        if not embs:
            return (torch.zeros(B, 0, cfg.hidden_size, device=dev),
                    torch.zeros(B, 0, dtype=torch.bool, device=dev))
        return torch.cat(embs, dim=1), torch.cat(masks, dim=1)

    @torch.no_grad()
    def encode(self, batch: MMTBatch) -> EncoderOutput:
        """Per-modality encoders + fusion encoder (float32)."""
        cfg = self.cfg
        B = batch.mw.shape[0]
        D = cfg.hidden_size
        L = cfg.nmr_seq_len
        dev = batch.mw.device
        cond_emb, cond_mask = self._cond_embeddings(batch)
        emb = self.spec_embed
        specs = {
            "1H": (F.relu(emb["embed_1h"](batch.src_1h.float())), batch.mask_1h),
            "13C": (F.relu(emb["embed_13c"](batch.src_13c.float()[..., None])), batch.mask_13c),
            "HSQC": (F.relu(emb["embed_hsqc"](batch.src_hsqc.float())), batch.mask_hsqc),
            "COSY": (F.relu(emb["embed_cosy"](batch.src_cosy.float())), batch.mask_cosy),
            # the IR token is always attended
            "IR": (F.relu(emb["embed_ir"](batch.src_ir.float()))[:, None, :],
                   torch.zeros(B, 1, dtype=torch.bool, device=dev)),
        }
        active = dict(zip(MODALITY_ORDER, (cfg.modalities.use_1h, cfg.modalities.use_13c,
                                           cfg.modalities.use_hsqc, cfg.modalities.use_cosy,
                                           cfg.modalities.use_ir)))
        pieces, masks = [], []
        for name, prefix in zip(MODALITY_ORDER, ENCODER_TORCH_PREFIXES):
            if active[name]:
                e, m = specs[name]
                x = torch.cat([e, cond_emb], dim=1)
                mk = torch.cat([m.bool(), cond_mask], dim=1)
                # the JAX package pads every lane to L for its stacked
                # encoder; masked padding is inert, so run at true length
                pieces.append(getattr(self, prefix)(x, mk))
                masks.append(mk)
            else:
                if name == "IR":
                    bl, blank_mask = cfg.ir_seq_len, False  # attended zeros
                elif name == "COSY":
                    bl, blank_mask = cfg.cosy_blank_len, True
                else:
                    bl, blank_mask = L, True
                pieces.append(torch.zeros(B, bl, D, device=dev))
                masks.append(torch.full((B, bl), blank_mask, dtype=torch.bool, device=dev))
        fused = torch.cat(pieces, dim=1)
        fused_mask = torch.cat(masks, dim=1)
        memory = self.encoder_cross(fused, fused_mask)
        # mean over the whole sequence, padded positions included
        fingerprint = self.fp1(memory.mean(dim=1))
        return EncoderOutput(memory, fused_mask, fingerprint)

    # ---------------------------------------------------------------- decoder

    @torch.no_grad()
    def decode(self, trg_tokens: torch.Tensor, memory: torch.Tensor,
               memory_key_padding_mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder pass -> logits [B, T, vocab]."""
        T = trg_tokens.shape[1]
        pos = torch.arange(T, device=trg_tokens.device)
        x = self.embed_trg(trg_tokens.long()) + self.pe_trg(pos)[None]
        mask = causal_mask(T, device=trg_tokens.device)
        dec = self.decoder(x, memory, mask, memory_key_padding_mask)
        logits = self.fc_out(dec)
        if self.cfg.use_real_data:
            blend = self.real_data_linear(memory.mean(dim=1))
            logits = (logits + blend[:, None, :]) / 2
        return logits


def load_model(path: str, cfg: ModelConfig = ModelConfig(), device: DeviceLike = None
               ) -> MultimodalTransformer:
    """A committed flax msgpack checkpoint -> an eval-mode model on ``device``
    (cuda unless asked otherwise)."""
    dev = resolve_device(device)
    model = MultimodalTransformer(cfg)
    model.load_state_dict(from_jax_params(read_msgpack(path)))
    return model.eval().to(dev)
