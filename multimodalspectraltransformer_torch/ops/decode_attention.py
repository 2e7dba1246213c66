"""Kernel K1: single-query causal self-attention for one KV-cached decode step.

``decode_attention(q, kv, pos)`` takes the pre-scaled queries ``q`` [B, H, Dh]
and one layer's merged cache ``kv`` [B, H, 2*Dh, T] (K in rows 0:Dh, V in
Dh:2*Dh, column ``pos`` already written), attends over keys 0..pos with an
f32 softmax and returns [B, H, Dh] in ``q.dtype``. It is the self-attention of
every greedy and fan-out decode step (``decode/functional.py::decoder_step``)
and replaces the JAX package's Pallas kernel ``ops/decode_attention.py``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/decode_attention.cu``) or raises; on a CPU tensor it runs
``decode_attention_plain``, the same function in plain PyTorch. The kernel
takes head sizes 8, 16, 32 and 64 (``HEAD_SIZES``), any batch, heads and
cache length.
"""

from __future__ import annotations

import torch

from . import _build

HEAD_SIZES = (8, 16, 32, 64)  # the head sizes the kernel is instantiated for

launches = 0  # kernel launches since the last reset (plain-version calls do not count)


def decode_attention_plain(q: torch.Tensor, kv: torch.Tensor, pos: int) -> torch.Tensor:
    """Plain PyTorch version: f32 scores over the live columns 0..pos, f32
    softmax, f32 weighted sum of V, one rounding to ``q.dtype`` at the end."""
    Dh = q.shape[-1]
    k = kv[:, :, :Dh, : pos + 1].float()
    v = kv[:, :, Dh:, : pos + 1].float()
    s = torch.einsum("bhd,bhdt->bht", q.float(), k)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhdt->bhd", p, v).to(q.dtype)


def _check(q: torch.Tensor, kv: torch.Tensor, pos: int) -> None:
    if q.dim() != 3 or kv.dim() != 4:
        raise ValueError(f"decode_attention: q must be [B, H, Dh] and kv [B, H, 2*Dh, T], got "
                         f"{tuple(q.shape)} and {tuple(kv.shape)}")
    B, H, Dh = q.shape
    if kv.shape[:3] != (B, H, 2 * Dh):
        raise ValueError(f"decode_attention: kv {tuple(kv.shape)} does not match q {tuple(q.shape)}")
    if q.dtype != kv.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q and kv must both be float32 or bfloat16, got "
                        f"{q.dtype} and {kv.dtype}")
    if q.device != kv.device:
        raise ValueError("decode_attention: q and kv lie on different devices")
    if not (0 <= pos < kv.shape[3]):
        raise ValueError(f"decode_attention: pos {pos} outside the cache of length {kv.shape[3]}")


def decode_attention(q: torch.Tensor, kv: torch.Tensor, pos: int) -> torch.Tensor:
    """[B, H, Dh] attention output; kernel on CUDA, plain version on the CPU."""
    global launches
    pos = int(pos)
    _check(q, kv, pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, kv, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and kv.is_contiguous()):
        raise ValueError("decode_attention: q and kv must be contiguous")
    B, H, Dh = q.shape
    if Dh not in HEAD_SIZES:
        raise ValueError(f"decode_attention: the kernel is built for head sizes {HEAD_SIZES}, "
                         f"got {Dh}")
    out = torch.empty_like(q)
    lib = _build.lib()
    err = lib.mmt_decode_attention(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), B, H, kv.shape[3], Dh, pos,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "mmt_decode_attention")
    launches += 1
    return out


def reset_launches() -> None:
    global launches
    launches = 0
