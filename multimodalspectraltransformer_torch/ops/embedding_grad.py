"""Kernel E1: the gradient of an embedding lookup, summed in a fixed order.

``embedding_lookup(weight, ids)`` is the row gather ``weight[ids]`` as an
autograd function whose backward is ``embedding_grad``: for each table row v
the sum of the incoming gradient's rows i with ``ids[i] == v``. Every lookup
table the port trains goes through it (``models/mmt.py``'s MF, MS, target and
position tables, ``rank/clip.py``'s word and position tables,
``rank/qformer.py``'s word table), so training repeats itself bit for bit on
the card: PyTorch's own CUDA backward of a lookup sums a row's contributions
in an order that can change between runs. The JAX package has no Pallas
kernel here (XLA's scatter-add); this kernel replaces none.

On a CUDA tensor ``embedding_grad`` sorts the flat ids with a stable sort and
launches the hand-written kernel (``csrc/embedding_grad.cu``) or raises; on a
CPU tensor it runs ``embedding_grad_plain``, a float32 ``index_add_`` in row
order. Both sum in float32 (the kernel with Neumaier's compensation) and
round once to the gradient's dtype (float32 or bfloat16); a float64 gradient
(the tensor-parallel check's float64 step) is summed in float64.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build

launches = 0  # kernel launches since the last reset (plain-version calls do not count)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}  # the kernel's dtype codes


def embedding_grad_plain(grad: torch.Tensor, ids: torch.Tensor, num_weights: int) -> torch.Tensor:
    """Plain PyTorch version: a float32 ``index_add_`` of the gradient's rows
    into a zero table (float64 for a float64 gradient, the exact reference
    the card's checks use), rounded once to ``grad.dtype``."""
    dim = grad.shape[-1]
    acc = torch.promote_types(grad.dtype, torch.float32)
    out = torch.zeros(num_weights, dim, dtype=acc, device=grad.device)
    out.index_add_(0, ids.reshape(-1).long(), grad.reshape(-1, dim).to(acc))
    return out.to(grad.dtype)


def _check(grad: torch.Tensor, ids: torch.Tensor, num_weights: int) -> None:
    if grad.dtype not in DTYPES:
        raise TypeError(f"embedding_grad: grad must be float32, bfloat16 or float64, got "
                        f"{grad.dtype}")
    if ids.dtype != torch.int64:
        raise TypeError(f"embedding_grad: ids must be int64, got {ids.dtype}")
    if grad.shape[:-1] != ids.shape:
        raise ValueError(f"embedding_grad: grad {tuple(grad.shape)} does not match ids "
                         f"{tuple(ids.shape)}")
    if num_weights <= 0 or grad.shape[-1] <= 0:
        raise ValueError(f"embedding_grad: empty table [{num_weights}, {grad.shape[-1]}]")
    if grad.device != ids.device:
        raise ValueError("embedding_grad: grad and ids lie on different devices")


def embedding_grad(grad: torch.Tensor, ids: torch.Tensor, num_weights: int) -> torch.Tensor:
    """[num_weights, D] gradient of the table from ``grad`` [*ids.shape, D];
    kernel on CUDA, plain version on the CPU."""
    global launches
    num_weights = int(num_weights)
    _check(grad, ids, num_weights)
    if grad.device.type == "cpu":
        return embedding_grad_plain(grad, ids, num_weights)
    if grad.device.type != "cuda":
        raise ValueError(f"embedding_grad: unsupported device {grad.device}")
    dim = grad.shape[-1]
    rows = grad.reshape(-1, dim).contiguous()
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    out = torch.empty(num_weights, dim, dtype=grad.dtype, device=grad.device)
    lib = _build.lib()
    err = lib.mmt_embedding_grad(
        rows.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(), out.data_ptr(),
        rows.shape[0], num_weights, dim, DTYPES[grad.dtype],
        _build.stream_ptr(grad.device),
    )
    _build.check(err, "mmt_embedding_grad")
    launches += 1
    return out


class EmbeddingLookup(torch.autograd.Function):
    """``weight[ids]`` with ``embedding_grad`` as its backward."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_weights = weight.shape[0]
        return weight.index_select(0, ids.reshape(-1)).view(*ids.shape, weight.shape[1])

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return embedding_grad(grad, ids, ctx.num_weights), None


def embedding_lookup(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``weight[ids]`` [*ids.shape, D] of the table ``weight`` [V, D]
    (``F.embedding`` without its options), differentiable in ``weight``
    through kernel E1."""
    return EmbeddingLookup.apply(weight, ids.long())


def reset_launches() -> None:
    global launches
    launches = 0
