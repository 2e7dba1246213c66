"""Train state: AdamW and the plateau schedule.

Counterpart of the JAX package's ``train/state.py``: AdamW (b1 0.9, b2 0.999,
eps 1e-8, decoupled weight decay ``cfg.weight_decay`` on every parameter)
whose learning rate is multiplied by the scale of a three-scalar
ReduceLROnPlateau (mode min, relative threshold 1e-4, cooldown 0), advanced
once per epoch by ``update_plateau``. ``cfg.trainable_only`` names the JAX
parameter paths (substrings) that train; every other parameter never moves,
weight decay included.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.convert import jax_paths
from ..utils.config import TrainConfig

# torch ReduceLROnPlateau's default relative improvement threshold
_PLATEAU_REL_THRESHOLD = 1e-4


@dataclass
class PlateauState:
    """ReduceLROnPlateau's state, as float32 and int32 scalars like the JAX
    package's."""

    best: np.float32 = field(default_factory=lambda: np.float32(np.inf))
    bad_count: int = 0
    scale: np.float32 = field(default_factory=lambda: np.float32(1.0))


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module  # holds the (float32 master) parameters
    optimizer: torch.optim.Optimizer
    plateau: PlateauState


def plateau_step(ps: PlateauState, loss: float, factor: float, patience: int) -> PlateauState:
    """One ReduceLROnPlateau update, in float32 as the JAX package computes it."""
    loss = np.float32(loss)
    improved = loss < ps.best * np.float32(1.0 - _PLATEAU_REL_THRESHOLD)
    best = min(ps.best, loss)
    bad = 0 if improved else ps.bad_count + 1
    if bad > patience:
        return PlateauState(best, 0, np.float32(ps.scale * np.float32(factor)))
    return PlateauState(best, bad, ps.scale)


def trainable_parameters(cfg: TrainConfig, model: torch.nn.Module) -> list[torch.nn.Parameter]:
    """The parameters whose JAX path contains one of ``cfg.trainable_only``
    (all of them when it is empty)."""
    named = list(model.named_parameters())
    if not cfg.trainable_only:
        return [p for _, p in named]
    paths = jax_paths(dict(named))
    return [p for n, p in named if any(s in paths[n] for s in cfg.trainable_only)]


def create_state(cfg: TrainConfig, model: torch.nn.Module) -> TrainState:
    opt = torch.optim.AdamW(trainable_parameters(cfg, model), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    return TrainState(0, model, opt, PlateauState())


def apply_grads(cfg: TrainConfig, state: TrainState) -> TrainState:
    """One optimizer application with the gradients held by the parameters.
    The plateau scale multiplies the learning rate; the plateau state only
    advances at epoch ends (``update_plateau``). A trainable parameter that
    got no gradient takes a zero one, so weight decay still moves it, as in
    optax."""
    lr = cfg.learning_rate * float(state.plateau.scale)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
    return state


def update_plateau(cfg: TrainConfig, state: TrainState, epoch_loss: float) -> TrainState:
    """Advance the plateau state once (at epoch end, with the monitored loss)."""
    state.plateau = plateau_step(state.plateau, epoch_loss, cfg.plateau_factor,
                                 cfg.plateau_patience)
    return state
