"""The collectives the parallel paths use.

- ``all_reduce_`` and ``broadcast_`` in place, ``all_gather`` of tensors and
  ``all_gather_object`` of any picklable result;
- ``dp_all_reduce_``: the sum over the data-parallel axes, in two stages on a
  multi-slice mesh (within each ``data`` group, then across ``dcn``), and
  ``grad_all_reduce_``, the mean of every gradient over them, in one flat
  buffer per stage;
- the two Megatron autograd functions: ``copy_to_model`` (the identity
  forward, an all-reduce of the gradient over the ``model`` group backward)
  and ``reduce_from_model`` (an all-reduce forward, the identity backward).

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` and moves them
through host memory itself; it has no ``all_gather`` for them, so
``all_gather`` copies CUDA tensors to the host, gathers there and copies the
result back. That is gloo's only route for them, not a fallback.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import RankShard


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` replaced by global rank ``src``'s tensor."""
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on all), in group-rank order."""
    src = t.contiguous()
    if _host_staged(src, group):
        out = [torch.empty_like(src, device="cpu") for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, src.cpu(), group=group)
        return [x.to(t.device) for x in out]
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return out


def all_gather_object(obj: Any, group=None) -> list:
    """Every rank's ``obj``, in group-rank order."""
    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def dp_all_reduce_(t: torch.Tensor, shard: RankShard) -> torch.Tensor:
    """The sum of ``t`` over the data-parallel axes, in place: over ``data``,
    then over ``dcn`` where the mesh has it."""
    for group in (shard.data_group, shard.dcn_group):
        if group is not None:
            all_reduce_(t, group)
    return t


def dp_mean(values: Sequence[torch.Tensor], shard: Optional[RankShard]) -> list[torch.Tensor]:
    """The mean over the data-parallel ranks of each scalar (one all-reduce)."""
    if shard is None or shard.dp_size == 1:
        return list(values)
    flat = dp_all_reduce_(torch.stack([v.detach().float() for v in values]), shard)
    return list(flat / shard.dp_size)


def dp_sum(value: torch.Tensor, shard: Optional[RankShard]) -> torch.Tensor:
    """The sum of ``value`` over the data-parallel ranks (a new tensor)."""
    if shard is None or shard.dp_size == 1:
        return value
    return dp_all_reduce_(value.detach().clone(), shard)


def grad_all_reduce_(grads: Sequence[torch.Tensor], shard: RankShard) -> None:
    """Every gradient replaced by its mean over the data-parallel ranks: one
    flat float32 buffer, summed per stage, divided by ``dp_size``. Runs on a
    world of one too (an exact identity), so a one-rank mesh goes through the
    same collectives."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dp_all_reduce_(flat, shard)
    if shard.dp_size > 1:
        flat /= shard.dp_size
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, accumulated in at least float32, in
    ``x``'s dtype."""
    y = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous().clone()
    all_reduce_(y, group)
    return y.to(x.dtype)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the entry of a tensor-parallel region."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of the model group's partial outputs."""
    return _ReduceFromModel.apply(x, group)


def dp_gather_rows(rows: Sequence, shard: Optional[RankShard]) -> list:
    """Every data-parallel rank's ``rows`` (a list of picklable items), joined
    in block order: the rows of the global batch. The ranks of one model group
    hold the same rows, and one copy of them is kept."""
    if shard is None or shard.dp_size == 1:
        return list(rows)
    got = all_gather_object((shard.dp_index, shard.tp_rank, list(rows)))
    return [r for _, _, part in sorted((g for g in got if g[1] == 0), key=lambda g: g[0])
            for r in part]
