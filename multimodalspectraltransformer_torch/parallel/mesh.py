"""Device meshes over ``torch.distributed``, and the sharding rules.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one program
over a mesh of devices (GSPMD); PyTorch runs one process per device, and the
API here is SPMD: every rank makes the same call (``run_training(mesh=...)``,
``evaluate_molecules(mesh=...)``) on its own device, and collectives join
them. So a mesh is a ``DeviceMesh`` over the world's ranks, laid out as JAX
reshapes its device list, and a "sharding" is what one rank holds:

- its contiguous rows of a global batch (``batch_sharding``): rank ``(c, d)``
  of the data-parallel grid takes block ``i = c * data + d``, as JAX's
  ``P(("dcn", "data"))`` places them;
- under tensor parallelism, its slice of each Megatron-split parameter
  (``param_shardings``, ``tp_slice``).

``init_distributed`` joins the world a launcher started
(``parallel/launch.py``, or ``torchrun``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``). ``RankShard`` is a rank's place on a mesh, which the model,
the train step and the harness read.

Random draws (dropout, the batch transforms, the samplers' Gumbel noise) are
made at the global shape from the generator one process would use, and each
rank keeps its slice (``draw``): every sharding then sees the one-process
draws, as JAX's threefry gives them.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"  # multi-slice axis: the slow links between groups of devices


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     device: Optional[str] = None) -> torch.device:
    """Join the world of ranks a launcher started and return this rank's
    device: ``cuda:LOCAL_RANK % device_count`` (``device="cpu"`` for the
    CPU). The backend defaults to ``nccl`` on CUDA and ``gloo`` on the CPU.
    Ranks that share a card must ask for ``backend="gloo"``: NCCL refuses two
    ranks on one device, so ``nccl`` there raises. Nothing falls back to
    another backend or device."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    else:
        n_cards = 0
        dev = torch.device("cpu")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use backend='gloo' on the CPU")
    if backend == "nccl" and local_world > n_cards:
        raise ValueError(f"{local_world} ranks share {n_cards} CUDA device(s) on this host, and "
                         "NCCL refuses two ranks on one device: pass backend='gloo'")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return dev


def mesh_layout(n: int, data: int = -1, model: int = 1, slices: Optional[int] = None
                ) -> np.ndarray:
    """The rank ids 0..n-1 laid out as ``(data, model)`` or, with ``slices``,
    ``(slices, data, model)``, in the order JAX reshapes its device list.
    Raises with JAX's messages when the sizes do not multiply to ``n``."""
    ids = np.arange(n)
    if slices is None:
        if data == -1:
            if n % model:
                raise ValueError(f"{n} devices not divisible by model={model}")
            data = n // model
        if data * model != n:
            raise ValueError(f"mesh {data}x{model} != {n} devices")
        return ids.reshape(data, model)
    if n % slices:
        raise ValueError(f"{n} devices not divisible by {slices} slices")
    per_slice = n // slices
    if data == -1:
        if per_slice % model:
            raise ValueError(f"{per_slice} devices a slice not divisible by model={model}")
        data = per_slice // model
    if slices * data * model != n:
        raise ValueError(f"mesh {slices}x{data}x{model} != {n}")
    return ids.reshape(slices, data, model)


def _device_mesh(layout: np.ndarray, devices: Optional[Sequence[int]], names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.asarray(list(devices) if devices is not None else range(layout.size))
    # the mesh's device type names where its collectives run: NCCL on the
    # cards; gloo takes its tensors through host memory either way
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.as_tensor(ranks[layout]), mesh_dim_names=names)


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence[int]] = None):
    """A ``(data, model)`` mesh over the world's ranks (or the rank ids in
    ``devices``); ``data=-1`` takes every remaining rank. Every rank calls it."""
    n = len(devices) if devices is not None else dist.get_world_size()
    return _device_mesh(mesh_layout(n, data, model), devices, (DATA_AXIS, MODEL_AXIS))


def make_multislice_mesh(slices: int, data: int = -1, model: int = 1,
                         devices: Optional[Sequence[int]] = None):
    """A ``(dcn, data, model)`` mesh, slice-major. The batch is sharded over
    (dcn, data), so the gradient all-reduce runs in two stages: within each
    ``data`` group, then across the ``dcn`` group
    (``collectives.dp_all_reduce_``); tensor-parallel collectives stay inside
    a slice."""
    n = len(devices) if devices is not None else dist.get_world_size()
    return _device_mesh(mesh_layout(n, data, model, slices), devices,
                        (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis)) if axis in mesh.mesh_dim_names else 1


def data_extent(mesh) -> int:
    """The number of ways ``batch_sharding`` splits a batch: dcn x data."""
    return _size(mesh, DATA_AXIS) * _size(mesh, DCN_AXIS)


class RankShard(NamedTuple):
    """One rank's place on a mesh: its block of batch rows (``dp_index`` of
    ``dp_size``) and its tensor-parallel slice (``tp_rank`` of ``tp_size``),
    with the process groups of its ``data``, ``dcn`` and ``model`` axes
    (None where the mesh has no such axis)."""

    dp_index: int = 0
    dp_size: int = 1
    tp_rank: int = 0
    tp_size: int = 1
    data_group: Any = None
    dcn_group: Any = None
    model_group: Any = None

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * dp_size`` rows."""
        return slice(self.dp_index * n_local, (self.dp_index + 1) * n_local)


def rank_shard(mesh) -> RankShard:
    """This rank's ``RankShard`` on ``mesh``."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    group = lambda axis: mesh.get_group(axis) if axis in names else None
    return RankShard(
        dp_index=coord.get(DCN_AXIS, 0) * _size(mesh, DATA_AXIS) + coord.get(DATA_AXIS, 0),
        dp_size=data_extent(mesh), tp_rank=coord.get(MODEL_AXIS, 0),
        tp_size=_size(mesh, MODEL_AXIS), data_group=group(DATA_AXIS), dcn_group=group(DCN_AXIS),
        model_group=group(MODEL_AXIS))


def batch_sharding(mesh, n_rows: int) -> slice:
    """This rank's contiguous rows of a global batch of ``n_rows`` (a multiple
    of ``data_extent``): block ``c * data + d`` of rank ``(c, d)``."""
    ext = data_extent(mesh)
    if n_rows % ext:
        raise ValueError(f"a batch of {n_rows} rows does not split {ext} ways")
    return rank_shard(mesh).rows(n_rows // ext)


def replicated(mesh) -> tuple:
    """The placement of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def shard_for_inference(mesh, params: dict, *batch_arrays):
    """Broadcast ``params`` (a state dict) from rank 0 and return ``(params,
    *each array's local rows)`` for fan-out decoding: every rank then decodes
    its molecules and all their lanes without talking to the others."""
    from .collectives import broadcast_

    params = {k: broadcast_(v.detach().clone()) for k, v in params.items()}
    rows = batch_sharding(mesh, batch_arrays[0].shape[0]) if batch_arrays else None
    return (params, *(a[rows] for a in batch_arrays))


def draw(fn: Callable, shape: Sequence[int], shard: Optional[RankShard] = None,
         tp_dim: Optional[int] = None, **kw) -> torch.Tensor:
    """``fn(shape, **kw)`` (``torch.rand``, ``torch.randn``) for this rank's
    part of a global tensor: drawn at the global shape (rows times
    ``dp_size``; dimension ``tp_dim`` times ``tp_size``) and sliced, so every
    sharding draws what one process draws."""
    shape = tuple(shape)
    if shard is None or (shard.dp_size == 1 and (tp_dim is None or shard.tp_size == 1)):
        return fn(shape, **kw)
    full, index = list(shape), [slice(None)] * len(shape)
    full[0] *= shard.dp_size
    index[0] = shard.rows(shape[0])
    if tp_dim is not None and shard.tp_size > 1:
        d = tp_dim % len(shape)
        full[d] *= shard.tp_size
        index[d] = slice(shard.tp_rank * shape[d], (shard.tp_rank + 1) * shape[d])
    return fn(tuple(full), **kw)[tuple(index)]


# --- tensor parallelism ------------------------------------------------------
#
# Megatron's split over the port's torch-layout names: attention head-parallel
# (the q, k and v rows of a rank's heads of in_proj, out_proj on the matching
# input columns), the feed-forward column-parallel (linear1's output rows) then
# row-parallel (linear2's input columns). Each rule gives the dimension counted
# from the right, so a leading stacked axis stays free, as JAX's right-aligned
# rule leaves it. Everything else is replicated.
_TP_RULES: list[tuple[re.Pattern, int, bool]] = [  # (name, dim from the right, q/k/v blocks)
    (re.compile(r"in_proj_weight$"), 2, True),
    (re.compile(r"in_proj_bias$"), 1, True),
    (re.compile(r"out_proj\.weight$"), 1, False),
    (re.compile(r"linear1\.weight$"), 2, False),
    (re.compile(r"linear1\.bias$"), 1, False),
    (re.compile(r"linear2\.weight$"), 1, False),
]


def _tp_rule(name: str) -> Optional[tuple[int, bool]]:
    for pat, dim, qkv in _TP_RULES:
        if pat.search(name):
            return dim, qkv
    return None


def param_shardings(mesh, state_dict: dict, tensor_parallel: bool = False) -> dict:
    """Each parameter name -> its placement on the ``model`` axis:
    ``Shard(dim)`` under the Megatron rules with ``tensor_parallel``, else
    ``Replicate()``. Unlike JAX's ``P("model", None)`` on ``in_proj_weight``
    (a contiguous row block, only a layout to GSPMD), a rank here computes
    with its shard, so ``Shard`` of an ``in_proj`` leaf holds *all of q, k
    and v for its heads* (``tp_slice``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = {}
    for name, t in state_dict.items():
        rule = _tp_rule(name) if tensor_parallel else None
        out[name] = Replicate() if rule is None else Shard(t.ndim - rule[0])
    return out


def tp_slice(name: str, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of parameter ``name`` under ``size``-way tensor
    parallelism (the whole tensor where the rules replicate it)."""
    rule = _tp_rule(name)
    if rule is None or size == 1:
        return t
    dim, qkv = t.ndim - rule[0], rule[1]
    blocks = t.chunk(3, dim) if qkv else (t,)
    for b in blocks:
        if b.shape[dim] % size:
            raise ValueError(f"{name}: {b.shape[dim]} does not split {size} ways")
    return torch.cat([b.chunk(size, dim)[rank] for b in blocks], dim).contiguous()


def tp_unslice(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole parameter ``name`` from every rank's shard, in rank order."""
    rule = _tp_rule(name)
    if rule is None or len(shards) == 1:
        return shards[0]
    dim, qkv = shards[0].ndim - rule[0], rule[1]
    if not qkv:
        return torch.cat(list(shards), dim)
    parts = [s.chunk(3, dim) for s in shards]
    return torch.cat([torch.cat([p[j] for p in parts], dim) for j in range(3)], dim)


def is_tp_sharded(name: str) -> bool:
    """Whether the rules split parameter ``name`` across the model axis."""
    return _tp_rule(name) is not None


def shard_model(model: torch.nn.Module, shard: RankShard) -> torch.nn.Module:
    """Put ``model`` on ``shard``, in place: every module that reads a
    ``shard`` (the transformer layers, their attention, the MMT) gets it, and
    under tensor parallelism each Megatron-split parameter becomes this rank's
    slice (``tp_slice``). Make the optimizer after this."""
    if shard.tp_size > 1:
        for m in model.modules():
            heads = getattr(m, "num_heads", None)
            if heads is not None and heads % shard.tp_size:
                raise ValueError(f"{heads} attention heads do not split {shard.tp_size} ways")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.data = tp_slice(name, p.data, shard.tp_rank, shard.tp_size)
    for m in model.modules():
        if getattr(type(m), "shard", False) is None:  # the classes that read a shard
            m.shard = shard
    return model


def gather_tp(name: str, t: torch.Tensor, shard: Optional[RankShard]) -> torch.Tensor:
    """The whole of parameter ``name`` (or a tensor shaped like it, such as
    its AdamW moments) from every model rank's shard; ``t`` itself where the
    rules replicate it."""
    if shard is None or shard.tp_size == 1 or not is_tp_sharded(name):
        return t
    from .collectives import all_gather

    return tp_unslice(name, all_gather(t, shard.model_group))


def gather_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s whole state dict on every rank (its own under no tensor
    parallelism), as one process holds it: what checkpoints, exports and the
    decoders read."""
    shard = getattr(model, "shard", None)
    return {k: gather_tp(k, v, shard) for k, v in model.state_dict().items()}


def broadcast_module(model: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` replaced by rank ``src``'s."""
    from .collectives import broadcast_

    with torch.no_grad():
        for t in model.state_dict().values():
            broadcast_(t, src)
    return model
