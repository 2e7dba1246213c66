"""The training step.

Counterpart of the JAX package's ``train/step.py``: ``loss_fn`` (the
teacher-forced loss, optionally in bfloat16 compute with float32 master
weights, optionally with two-pass scheduled sampling), ``train_step``
(backward, the global gradient norm, one AdamW application), ``eval_step``,
and the batch transforms that run on the device: modality blanking, per-peak
jitter and the smooth ppm-axis warp.

Randomness comes from explicit generators. Each step's dropout generator is
made from ``(seed, step)`` (``step_generator``), as JAX's
``fold_in(rng, step)``, so a resumed run draws the masks the uninterrupted
run would. Each random function also takes its draws injected (``noise``),
which the tests use to feed the JAX package's own draws. JAX's
``fast_dropout_rng`` (the TPU's hardware RNG) has no counterpart here: the
option is accepted and changes nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import TrainBatch
from ..models.mmt import MultimodalTransformer, split_generator
from ..utils import vocab
from ..utils.config import MMTConfig
from . import loss as loss_mod
from .state import TrainState, apply_grads


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    smi_loss: torch.Tensor
    fp_loss: torch.Tensor
    token_accuracy: torch.Tensor  # teacher-forced next-token accuracy (non-pad)
    grad_norm: torch.Tensor


def fold_seed(seed: int, *path: int) -> int:
    """A 64-bit seed from ``(seed, *path)`` through numpy's SeedSequence: the
    counterpart of JAX's ``fold_in``."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0])


def fold_generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``fold_seed(seed, *path)``."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, *path))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s dropout seeds."""
    return fold_generator(seed, step)


def _replace_inputs(batch: TrainBatch, **fields) -> TrainBatch:
    return batch._replace(inputs=batch.inputs._replace(**fields))


def _live(mask: torch.Tensor, dtype) -> torch.Tensor:
    return (mask == 0).to(dtype)


def blank_modalities_device(batch: TrainBatch, p: float,
                            generator: Optional[torch.Generator] = None,
                            uniform: Optional[torch.Tensor] = None) -> TrainBatch:
    """Per-sample modality blanking: each present modality is blanked with
    probability ``p`` (its spectrum zeroed, its mask all padding); where
    everything got blanked, 1H and 13C are restored. ``uniform`` [B, 5]
    replaces the draws from ``generator``."""
    inp = batch.inputs
    B = inp.mw.shape[0]
    dev = inp.mw.device
    present = torch.stack([
        (inp.mask_1h == 0).any(dim=1), (inp.mask_13c == 0).any(dim=1),
        (inp.mask_hsqc == 0).any(dim=1), (inp.mask_cosy == 0).any(dim=1),
        (inp.src_ir != 0).any(dim=1),
    ], dim=1)
    if uniform is None:
        uniform = torch.rand(B, 5, generator=generator, device=dev)
    keep = present & ~(uniform.to(dev) < p)
    none_kept = ~keep.any(dim=1)
    keep[:, :2] = torch.where(none_kept[:, None], present[:, :2], keep[:, :2])

    def apply(src, mask, k):
        kk = k.reshape((B,) + (1,) * (src.ndim - 1))
        return src * kk.to(src.dtype), torch.where(k[:, None], mask, torch.ones_like(mask))

    s1h, m1h = apply(inp.src_1h, inp.mask_1h, keep[:, 0])
    s13c, m13c = apply(inp.src_13c, inp.mask_13c, keep[:, 1])
    shsqc, mhsqc = apply(inp.src_hsqc, inp.mask_hsqc, keep[:, 2])
    scosy, mcosy = apply(inp.src_cosy, inp.mask_cosy, keep[:, 3])
    sir = inp.src_ir * keep[:, 4][:, None].to(inp.src_ir.dtype)
    return _replace_inputs(batch, src_1h=s1h, mask_1h=m1h, src_13c=s13c, mask_13c=m13c,
                           src_hsqc=shsqc, mask_hsqc=mhsqc, src_cosy=scosy, mask_cosy=mcosy,
                           src_ir=sir)


def jitter_spectra_device(batch: TrainBatch, generator: Optional[torch.Generator] = None,
                          sigma_h: float = 0.2, sigma_c: float = 3.0, gate_p: float = 0.5,
                          noise: Optional[Sequence[torch.Tensor]] = None) -> TrainBatch:
    """Per-peak Gaussian jitter of the NMR coordinates (sigmas in ppm), each
    sample jittered with probability ``gate_p``; 1H intensities and padded
    slots untouched. ``noise`` = (gate uniform [B], 1H [B, P], 13C [B, P],
    HSQC H [B, P], HSQC C [B, P], COSY [B, P, 2]) standard draws replaces the
    draws from ``generator``."""
    inp = batch.inputs
    B, P = inp.src_1h.shape[:2]
    dev, dt = inp.mw.device, inp.src_1h.dtype
    if noise is None:
        g = lambda *s: torch.randn(*s, generator=generator, device=dev)
        noise = (torch.rand(B, generator=generator, device=dev), g(B, P), g(B, P), g(B, P),
                 g(B, P), g(B, P, 2))
    u, n1h, n13c, nh, nc, ncosy = (torch.as_tensor(x, device=dev) for x in noise)
    gate = (u < gate_p).to(dt)
    sh, sc = sigma_h / 10.0, sigma_c / 200.0
    g1, g2 = gate[:, None], gate[:, None, None]
    d1h = torch.stack([n1h * sh, torch.zeros_like(n1h)], dim=-1)
    s1h = inp.src_1h + d1h * _live(inp.mask_1h, dt)[..., None] * g2
    s13c = inp.src_13c + n13c * sc * _live(inp.mask_13c, dt) * g1
    dhsqc = torch.stack([nh * sh, nc * sc], dim=-1)
    shsqc = inp.src_hsqc + dhsqc * _live(inp.mask_hsqc, dt)[..., None] * g2
    scosy = inp.src_cosy + ncosy * sh * _live(inp.mask_cosy, dt)[..., None] * g2
    return _replace_inputs(batch, src_1h=s1h, src_13c=s13c, src_hsqc=shsqc, src_cosy=scosy)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` per row: x [B, P], knots xp [K], values fp [B, K]."""
    K = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, K - 1)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    x0 = xp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (f1 - f0)
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def warp_spectra_device(batch: TrainBatch, generator: Optional[torch.Generator] = None,
                        sigma_h: float = 0.3, sigma_c: float = 4.0, gate_p: float = 0.5,
                        knots_h: int = 5, knots_c: int = 6,
                        noise: Optional[Sequence[torch.Tensor]] = None) -> TrainBatch:
    """Per-sample smooth random warp of the ppm axes, the same on every
    modality: offsets drawn at ``knots_c`` (``knots_h``) knots spanning the
    13C (1H) axis are interpolated linearly and added to every carbon (proton)
    coordinate: 13C peaks and HSQC C (1H, HSQC H and both COSY coordinates).
    Each sample is warped with probability ``gate_p``; padded slots stay
    zero. ``noise`` = (gate uniform [B], standard normals [B, knots_c] and
    [B, knots_h]) replaces the draws from ``generator``."""
    inp = batch.inputs
    B = inp.mw.shape[0]
    dev, dt = inp.mw.device, inp.src_1h.dtype
    if noise is None:
        noise = (torch.rand(B, generator=generator, device=dev),
                 torch.randn(B, knots_c, generator=generator, device=dev),
                 torch.randn(B, knots_h, generator=generator, device=dev))
    u, zc, zh = (torch.as_tensor(x, device=dev) for x in noise)
    gate = (u < gate_p).to(dt)
    kc = torch.linspace(-0.05, 1.15, knots_c, device=dev)
    kh = torch.linspace(-0.05, 1.15, knots_h, device=dev)
    dc = zc * (sigma_c / 200.0) * gate[:, None]
    dh = zh * (sigma_h / 10.0) * gate[:, None]

    def warp(x, mask, knots, d):
        return torch.where(mask == 0, x + _interp(x, knots, d), x)

    s13c = warp(inp.src_13c, inp.mask_13c, kc, dc)
    s1h = torch.stack([warp(inp.src_1h[..., 0], inp.mask_1h, kh, dh), inp.src_1h[..., 1]], dim=-1)
    shsqc = torch.stack([warp(inp.src_hsqc[..., 0], inp.mask_hsqc, kh, dh),
                         warp(inp.src_hsqc[..., 1], inp.mask_hsqc, kc, dc)], dim=-1)
    scosy = torch.stack([warp(inp.src_cosy[..., 0], inp.mask_cosy, kh, dh),
                         warp(inp.src_cosy[..., 1], inp.mask_cosy, kh, dh)], dim=-1)
    return _replace_inputs(batch, src_1h=s1h, src_13c=s13c, src_hsqc=shsqc, src_cosy=scosy)


def compute_dtype(cfg: MMTConfig) -> torch.dtype:
    """bfloat16 under ``mixed_precision`` (or a bfloat16 model), else the
    model's dtype."""
    return torch.bfloat16 if cfg.train.mixed_precision else getattr(torch, cfg.model.dtype)


def _token_accuracy(logits: torch.Tensor, trg_tokens: torch.Tensor) -> torch.Tensor:
    targets = trg_tokens[:, 1:].long()
    live = targets != vocab.PAD_ID
    hits = ((logits.argmax(dim=-1) == targets) & live).sum()
    return hits / live.sum().clamp_min(1)


def loss_fn(model: MultimodalTransformer, cfg: MMTConfig, batch: TrainBatch,
            generator: Optional[torch.Generator] = None, step: int = 0,
            noise: Optional[Sequence[torch.Tensor]] = None):
    """The training loss with gradients -> (total, (LossOutput, token
    accuracy)). With ``cfg.train.ss_prob > 0``, two-pass scheduled sampling:
    encode once (dropout on); a gradient-free deterministic decode gives the
    model's own sampled tokens, which replace non-pad decoder inputs after
    <SOS> at the ramped rate ``ss_prob * min(1, step / ss_ramp_steps)``; the
    loss comes from a second decode of the mixed inputs. ``noise`` = (Gumbel
    [B, T, V], uniform [B, T]) replaces the sampling draws."""
    dt = compute_dtype(cfg)
    t = cfg.train
    if t.ss_prob > 0.0:
        g_enc, g_samp, g_mix, g_dec = split_generator(generator, 4)
        enc = model(batch.inputs, generator=g_enc, dtype=dt)
        dec_in = batch.trg_tokens[:, :-1].long()
        with torch.no_grad():
            logits1 = model.decode_train(dec_in, enc.memory, enc.memory_key_padding_mask,
                                         None, dt).float()
        if noise is None:
            dev = logits1.device
            u = torch.rand(logits1.shape, generator=g_samp).to(dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            noise = (gumbel, torch.rand(dec_in.shape, generator=g_mix).to(dev))
        gumbel, uniform = (torch.as_tensor(x, device=dec_in.device) for x in noise)
        sampled = (logits1 + gumbel).argmax(dim=-1)
        pred_for_pos = torch.cat([dec_in[:, :1], sampled[:, :-1]], dim=1)
        p_live = t.ss_prob * float(np.clip(step / max(t.ss_ramp_steps, 1), 0.0, 1.0))
        pos = torch.arange(dec_in.shape[1], device=dec_in.device)[None, :]
        replace = (uniform < p_live) & (dec_in != vocab.PAD_ID) & (pos >= 1)
        mixed = torch.where(replace, pred_for_pos, dec_in)
        logits = model.decode_train(mixed, enc.memory, enc.memory_key_padding_mask, g_dec, dt)
        fp_logits = enc.fingerprint
    else:
        logits, fp_logits, _, _ = model(batch.inputs, batch.trg_tokens[:, :-1], generator, dt)
    logits = logits.float()
    out = loss_mod.total_loss(logits, batch.trg_tokens, fp_logits.float(), batch.trg_fp,
                              weight_smi=t.weight_smi, weight_fp=t.weight_fp)
    return out.total, (out, _token_accuracy(logits.detach(), batch.trg_tokens))


def train_step(cfg: MMTConfig, state: TrainState, batch: TrainBatch, seed: int = 0,
               noise: Optional[Sequence[torch.Tensor]] = None) -> tuple[TrainState, StepMetrics]:
    """One step: the loss with dropout from ``step_generator(seed,
    state.step)``, its gradients, their global norm, one AdamW application."""
    model = state.model
    model.train()
    model.zero_grad(set_to_none=True)
    total, (out, acc) = loss_fn(model, cfg, batch, step_generator(seed, state.step), state.step,
                                noise)
    total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    apply_grads(cfg.train, state)
    return state, StepMetrics(total.detach(), out.smi_loss.detach(), out.fp_loss.detach(), acc,
                              gnorm)


@torch.no_grad()
def eval_step(cfg: MMTConfig, model: MultimodalTransformer, batch: TrainBatch) -> StepMetrics:
    """The loss without dropout or gradients, in the model's dtype."""
    model.eval()
    logits, fp_logits, _, _ = model(batch.inputs, batch.trg_tokens[:, :-1])
    logits = logits.float()
    out = loss_mod.total_loss(logits, batch.trg_tokens, fp_logits.float(), batch.trg_fp,
                              weight_smi=cfg.train.weight_smi, weight_fp=cfg.train.weight_fp)
    return StepMetrics(out.total, out.smi_loss, out.fp_loss,
                       _token_accuracy(logits, batch.trg_tokens),
                       torch.zeros((), device=logits.device))
