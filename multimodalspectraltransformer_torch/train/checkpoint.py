"""Checkpoints of the training state, and the flat parameter export.

Counterpart of the JAX package's ``train/checkpoint.py``, whose Orbax manager
becomes a small manager over ``torch.save``: one file per saved step
(``<dir>/<step>.pt``) holding the parameters, the AdamW state, the plateau
state and the step, written to a per-process temporary name and moved into
place; the newest ``keep`` stay. Saves are synchronous, so ``wait`` and
``close`` have nothing to do. ``export_params_msgpack`` writes the parameters
in the JAX package's flax msgpack format, which its ``import_params_msgpack``
and the port's ``read_msgpack`` both read.

Under a mesh (the model's ``shard``) every rank calls ``save`` and ``restore``:
a tensor-parallel state is gathered whole first, so a file holds what one
process would save; rank 0 alone writes (``writer``), and the ranks meet at a
barrier after each save. A restore is read by rank 0 and broadcast, and each
rank keeps its shard of it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.convert import from_jax_params, read_msgpack, to_jax_params, write_msgpack
from ..parallel.mesh import gather_tp, tp_slice
from .state import PlateauState, TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _param_names(state: TrainState) -> list[str]:
    """The names of the optimizer's parameters, in its state dict's order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _map_optimizer(opt_sd: dict, names: list[str], fn) -> dict:
    """The optimizer state dict with ``fn(name, tensor)`` applied to each
    per-parameter tensor (the AdamW moments; not the step counts)."""
    state = {i: {k: fn(names[i], v) if isinstance(v, torch.Tensor) and v.ndim else v
                 for k, v in st.items()} for i, st in opt_sd["state"].items()}
    return {**opt_sd, "state": state}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, save_interval_steps: int = 1,
                 writer: bool = True):
        """``writer=False`` (every rank but 0 under a mesh): the manager reads
        and writes no file; it follows the steps that rank 0 saves, so every
        rank agrees on when a save happens."""
        self._dir = os.path.abspath(directory)
        self.writer = writer
        self._followed: Optional[int] = None  # the latest saved step, as a non-writer knows it
        if writer:
            os.makedirs(self._dir, exist_ok=True)
        self.keep = keep
        self.save_interval_steps = save_interval_steps

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self._dir)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def should_save(self, step: int) -> bool:
        """Whether ``save`` at this step would write: a multiple of the
        interval that is newer than every saved step."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        return step % max(self.save_interval_steps, 1) == 0

    def save(self, state: TrainState, metrics: Optional[dict] = None) -> bool:
        if not self.should_save(state.step):
            return False
        shard = state.model.shard
        params = {k: gather_tp(k, v, shard) for k, v in state.model.state_dict().items()}
        optimizer = _map_optimizer(state.optimizer.state_dict(), _param_names(state),
                                   lambda n, t: gather_tp(n, t, shard))
        if not self.writer:
            self._followed = state.step
            dist.barrier()
            return True
        payload = {
            "step": state.step,
            "params": params,
            "optimizer": optimizer,
            "plateau": {"best": float(state.plateau.best), "bad_count": state.plateau.bad_count,
                        "scale": float(state.plateau.scale)},
            "metrics": metrics or {},
        }
        path = self._path(state.step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self._steps()[: -self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))
        if shard is not None:
            dist.barrier()
        return True

    def restore(self, template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load a saved step (the latest by default) into ``template``'s model
        and optimizer; None if there is none. Under a mesh rank 0 reads it and
        broadcasts it, and each rank loads its shard."""
        shard = template.model.shard
        payload = None
        if self.writer:
            target = step if step is not None else self.latest_step()
            if target is not None:
                payload = torch.load(self._path(target), map_location="cpu", weights_only=True)
        if shard is not None:
            box = [payload]
            dist.broadcast_object_list(box, src=0)
            payload = box[0]
        if payload is None:
            return None
        if shard is not None:
            cut = lambda n, t: tp_slice(n, t, shard.tp_rank, shard.tp_size)
            payload["params"] = {k: cut(k, v) for k, v in payload["params"].items()}
            payload["optimizer"] = _map_optimizer(payload["optimizer"], _param_names(template),
                                                  cut)
            self._followed = int(payload["step"])
        template.model.load_state_dict(payload["params"])
        template.optimizer.load_state_dict(payload["optimizer"])
        p = payload["plateau"]
        template.plateau = PlateauState(np.float32(p["best"]), int(p["bad_count"]),
                                        np.float32(p["scale"]))
        template.step = int(payload["step"])
        return template

    def latest_step(self) -> Optional[int]:
        if not self.writer:
            return self._followed
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


def export_params_msgpack(params: Any, path: str, dtype: Optional[torch.dtype] = None) -> None:
    """The parameters (a model or its state dict) as a flax msgpack file in the
    JAX package's tree; ``.gz`` gzips it, and ``dtype`` (e.g.
    ``torch.bfloat16``) casts every leaf first."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    tree = to_jax_params(sd)
    if dtype is not None:
        def cast(node):
            if isinstance(node, dict):
                return {k: cast(v) for k, v in node.items()}
            return torch.from_numpy(node).to(dtype)
        tree = cast(tree)
    write_msgpack(tree, path)


def import_params_msgpack(path: str) -> dict[str, torch.Tensor]:
    """A flax msgpack parameter file (``.gz`` too, bf16 leaves too) -> the
    port's float32 state dict."""
    return from_jax_params(read_msgpack(path))
