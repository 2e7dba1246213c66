"""Kernel K3: ancestry-masked self-attention for one beam-search decode step.

``beam_attention(q, kv, bias, n_live)`` takes the pre-scaled queries ``q``
[B, H, K, Dh] of the K beams, one layer's append-only beam cache ``kv``
[B, H, 2*Dh, M] (K in rows 0:Dh, V in Dh:2*Dh; column t*K + l is what lane l
wrote at step t) and the additive ancestry bias [B, K, M] (0 where lane l held
beam k's ancestor at step t <= pos, -inf elsewhere), and returns
``softmax(q . K + bias) . V`` as [B, H, K, Dh] in ``q.dtype``. Only the first
``n_live`` columns are read (``(pos + 1) * K`` on the beam path, where the
bias is -inf beyond them, so the function is unchanged). It is the
self-attention of every step of ``decode/functional.py::beam_decoder_step``
and replaces the JAX package's Pallas kernel ``ops/beam_attention.py``.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/beam_attention.cu``) or raises; on a CPU tensor it runs
``beam_attention_plain``, the same function in plain PyTorch. The kernel
takes head sizes 8, 16, 32 and 64 (``HEAD_SIZES``) and any number of beams:
it runs them in groups of at most ``MAX_GROUP`` (``beam_groups``), each group
reading the cache again.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

MAX_GROUP = 16  # beams one block of the kernel serves, one warp each
HEAD_SIZES = (8, 16, 32, 64)  # the head sizes the kernel is instantiated for

launches = 0  # kernel launches since the last reset (plain-version calls do not count)


def beam_attention_plain(q: torch.Tensor, kv: torch.Tensor, bias: torch.Tensor,
                         n_live: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version, the Pallas kernel's arithmetic: f32 scores plus
    the f32 bias, f32 softmax, probabilities rounded to the cache's type, f32
    weighted sum of V, one rounding to ``q.dtype``. A row whose bias is -inf
    everywhere gives NaN (as in the JAX function; the beam path has none)."""
    Dh = q.shape[-1]
    n = kv.shape[-1] if n_live is None else n_live
    k = kv[:, :, :Dh, :n].float()
    v = kv[:, :, Dh:, :n].float()
    s = torch.einsum("bhkd,bhdm->bhkm", q.float(), k) + bias[:, None, :, :n].float()
    p = torch.softmax(s, dim=-1).to(kv.dtype).float()
    return torch.einsum("bhkm,bhdm->bhkd", p, v).to(q.dtype)


def _check(q: torch.Tensor, kv: torch.Tensor, bias: torch.Tensor, n_live: int) -> None:
    if q.dim() != 4 or kv.dim() != 4 or bias.dim() != 3:
        raise ValueError(f"beam_attention: q must be [B, H, K, Dh], kv [B, H, 2*Dh, M] and bias "
                         f"[B, K, M], got {tuple(q.shape)}, {tuple(kv.shape)}, {tuple(bias.shape)}")
    B, H, K, Dh = q.shape
    M = kv.shape[3]
    if kv.shape[:3] != (B, H, 2 * Dh) or bias.shape != (B, K, M):
        raise ValueError(f"beam_attention: kv {tuple(kv.shape)} and bias {tuple(bias.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (q.dtype == kv.dtype == bias.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"beam_attention: q, kv and bias must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {kv.dtype} and {bias.dtype}")
    if not (q.device == kv.device == bias.device):
        raise ValueError("beam_attention: q, kv and bias lie on different devices")
    if not (0 < n_live <= M):
        raise ValueError(f"beam_attention: n_live {n_live} outside the cache of {M} columns")


def beam_groups(k: int) -> tuple[int, int]:
    """(groups, beams per group) the kernel splits ``k`` beams into: the
    fewest groups of at most ``MAX_GROUP``, as even as they can be (the last
    may be smaller)."""
    n = -(-k // MAX_GROUP)
    return n, -(-k // n)


def beam_attention(q: torch.Tensor, kv: torch.Tensor, bias: torch.Tensor,
                   n_live: Optional[int] = None) -> torch.Tensor:
    """[B, H, K, Dh] attention output; kernel on CUDA, plain version on the CPU."""
    global launches
    n_live = kv.shape[-1] if n_live is None else int(n_live)
    _check(q, kv, bias, n_live)
    if q.device.type == "cpu":
        return beam_attention_plain(q, kv, bias, n_live)
    if q.device.type != "cuda":
        raise ValueError(f"beam_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and kv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("beam_attention: q, kv and bias must be contiguous")
    B, H, K, Dh = q.shape
    if Dh not in HEAD_SIZES:
        raise ValueError(f"beam_attention: the kernel is built for head sizes {HEAD_SIZES}, "
                         f"got {Dh}")
    out = torch.empty_like(q)
    err = _build.lib().mmt_beam_attention(
        q.data_ptr(), kv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, K, kv.shape[3], Dh,
        n_live, beam_groups(K)[1], int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "mmt_beam_attention")
    launches += 1
    return out


def reset_launches() -> None:
    global launches
    launches = 0
