"""Checkpoints of the training state, and the flat parameter export.

Counterpart of the JAX package's ``train/checkpoint.py``, whose Orbax manager
becomes a small manager over ``torch.save``: one file per saved step
(``<dir>/<step>.pt``) holding the parameters, the AdamW state, the plateau
state and the step, written to a per-process temporary name and moved into
place; the newest ``keep`` stay. Saves are synchronous, so ``wait`` and
``close`` have nothing to do. ``export_params_msgpack`` writes the parameters
in the JAX package's flax msgpack format, which its ``import_params_msgpack``
and the port's ``read_msgpack`` both read.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ..models.convert import from_jax_params, read_msgpack, to_jax_params, write_msgpack
from .state import PlateauState, TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, save_interval_steps: int = 1):
        self._dir = os.path.abspath(directory)
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
        payload = {
            "step": state.step,
            "params": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
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
        return True

    def restore(self, template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load a saved step (the latest by default) into ``template``'s model
        and optimizer; None if there is none."""
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        payload = torch.load(self._path(target), map_location="cpu", weights_only=True)
        template.model.load_state_dict(payload["params"])
        template.optimizer.load_state_dict(payload["optimizer"])
        p = payload["plateau"]
        template.plateau = PlateauState(np.float32(p["best"]), int(p["bad_count"]),
                                        np.float32(p["scale"]))
        template.step = int(payload["step"])
        return template

    def latest_step(self) -> Optional[int]:
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
