"""The GNN simulators' data, training and weight files.

Counterpart of the JAX package's ``sim/distill.py``: ``featurize_compact``
packs a molecule as int8 node features and an int8 edge list;
``densify_batch`` expands a stacked batch on the device into float node
features, per-bond-type symmetric adjacency and the node mask, without a
host sync; ``build_teacher_dataset`` labels a corpus with the rule teachers
(``shift_rules``, ``ir_rules``); ``train_shift_model`` / ``train_ir_model``
distill them into ``gnn.NMRShiftModel`` / ``gnn.IRModel`` with optax's
AdamW on a cosine-decay schedule, drawing the JAX trainer's batches from the
same numpy generator; ``save_*_weights`` write flax's msgpack files and the
JSON meta, which ``load_*_weights`` (and the JAX package's loaders) read.
The committed weights are read in place from
``multimodalspectraltransformer_tpu/sim/weights/``; the savers have no
default directory, so they never write there unless told to.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..chem.smiles import parse_smiles
from ..models.convert import linear_params, linear_tree, read_msgpack, write_msgpack
from ..models.layers import init_like_flax
from ..utils.device import DeviceLike, resolve_device
from . import ir_rules, shift_rules
from .graphs import BOND_TYPES, ELEMENTS, MAX_DEGREE, MAX_H, N_ELEM, NODE_FEATURES

MAX_EDGES = 96

# the committed distilled weights live beside the JAX package's simulator
WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "multimodalspectraltransformer_tpu", "sim", "weights",
)


def featurize_compact(mol, max_nodes: int = 64, max_edges: int = MAX_EDGES):
    """(nodes int8 [N,F], edges int8 [E,3] (a1,a2,type; pad type=-1),
    n_atoms) or None if oversized."""
    n = mol.num_atoms
    if n > max_nodes or len(mol.bonds) > max_edges:
        return None
    nodes = np.zeros((max_nodes, NODE_FEATURES), np.int8)
    for i, a in enumerate(mol.atoms):
        f = nodes[i]
        idx = ELEMENTS.index(a.symbol) if a.symbol in ELEMENTS else N_ELEM - 1
        f[idx] = 1
        f[N_ELEM + min(mol.degree(i), MAX_DEGREE)] = 1
        f[N_ELEM + MAX_DEGREE + 1 + min(mol.total_h(i), MAX_H)] = 1
        base = N_ELEM + MAX_DEGREE + 1 + MAX_H + 1
        f[base] = np.int8(a.charge)
        f[base + 1] = np.int8(a.aromatic)
        f[base + 2] = np.int8(a.in_ring)
    edges = np.full((max_edges, 3), -1, np.int8)
    for k, b in enumerate(mol.bonds):
        t = 3 if b.aromatic else b.order - 1
        edges[k] = (b.a1, b.a2, t)
    return nodes, edges, n


def densify_batch(nodes_i8: torch.Tensor, edges_i8: torch.Tensor, n_atoms: torch.Tensor,
                  max_nodes: int = 64):
    """Compact batch on the device -> (nodes f32 [B, N, F], adj f32
    [B, T, N, N] symmetric, mask f32 [B, N]). Every edge slot is scattered,
    a padded one (type -1) as 0.0 onto entry (b, 0, 0, 0): the shapes never
    depend on the data, so nothing waits for the device."""
    dev = nodes_i8.device
    nodes = nodes_i8.float()
    batch = nodes.shape[0]
    mask = (torch.arange(max_nodes, device=dev)[None, :] < n_atoms[:, None]).float()
    e = edges_i8.long()
    valid = (e[..., 2] >= 0).float()
    a1, a2, t = (e[..., i].clamp_min(0) for i in range(3))
    b = torch.arange(batch, device=dev)[:, None]
    flat = ((b * BOND_TYPES + t) * max_nodes + a1) * max_nodes + a2
    adj = torch.zeros(batch * BOND_TYPES * max_nodes * max_nodes, device=dev)
    adj.scatter_add_(0, flat.reshape(-1), valid.reshape(-1))
    adj = adj.view(batch, BOND_TYPES, max_nodes, max_nodes)
    return nodes, adj + adj.transpose(2, 3), mask


# ---------------------------------------------------------------------------
# teacher dataset
# ---------------------------------------------------------------------------

def build_teacher_dataset(
    smiles_list: Sequence[str], max_nodes: int = 64, with_ir: bool = True
) -> dict:
    """Compact arrays: graphs + rule-teacher shift/IR targets."""
    nodes, edges, n_atoms = [], [], []
    tc, mc, th, mh = [], [], [], []
    irs = []
    kept_smiles = []
    for smi in smiles_list:
        try:
            mol = parse_smiles(smi)
        except Exception:  # the JAX package skips every SMILES its parser refuses
            continue
        compact = featurize_compact(mol, max_nodes)
        if compact is None:
            continue
        sh = shift_rules.predict_shifts(mol)
        t_c = np.zeros(max_nodes, np.float32)
        m_c = np.zeros(max_nodes, np.uint8)
        t_h = np.zeros(max_nodes, np.float32)
        m_h = np.zeros(max_nodes, np.uint8)
        for i, a in enumerate(mol.atoms):
            if a.symbol == "C":
                t_c[i] = sh.shift_c[i]
                m_c[i] = 1
            if a.symbol == "C" and mol.total_h(i) > 0:
                t_h[i] = sh.shift_h[i]
                m_h[i] = 1
        nodes.append(compact[0])
        edges.append(compact[1])
        n_atoms.append(compact[2])
        tc.append(t_c)
        mc.append(m_c)
        th.append(t_h)
        mh.append(m_h)
        if with_ir:
            spec = ir_rules.predict_ir(mol)
            irs.append(np.round(spec * 255.0).astype(np.uint8))
        kept_smiles.append(smi)
    out = {
        "nodes": np.stack(nodes),
        "edges": np.stack(edges),
        "n_atoms": np.asarray(n_atoms, np.int32),
        "target_c": np.stack(tc),
        "mask_c": np.stack(mc),
        "target_h": np.stack(th),
        "mask_h": np.stack(mh),
        "smiles": kept_smiles,
    }
    if with_ir:
        out["ir"] = np.stack(irs)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def cosine_decay_lr(lr: float, n_steps: int, step: int, alpha: float = 0.05) -> float:
    """``optax.cosine_decay_schedule(lr, n_steps, alpha)`` at ``step``
    (counted from 0, as optax counts its updates)."""
    t = min(step, n_steps)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / n_steps)) + alpha)


def _park(data: dict, keys: Sequence[str], dev: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(data[k])).to(dev) for k in keys}


def _dense(d: dict, idx: torch.Tensor):
    return densify_batch(d["nodes"][idx], d["edges"][idx], d["n_atoms"][idx])


def _split(m: int, val_frac: float, rng: np.random.Generator):
    n_val = max(1, int(m * val_frac))
    perm = rng.permutation(m)
    return n_val, perm[:n_val], perm[n_val:]


def _start(model: torch.nn.Module, init_params: Optional[Mapping], seed: int,
           dev: torch.device) -> torch.nn.Module:
    """``init_params`` (a state dict) or flax's initializer drawn on the CPU
    from ``seed``, so every device starts from the same weights."""
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


class OptaxAdamW:
    """``optax.adamw``'s update in its float32 order: the moments
    ``(1-b)*g + b*m``, the bias corrections ``1 - b**t`` computed from float32
    betas (1 - 0.999f is 1.3e-5 below 1e-3, which ``torch.optim.AdamW``'s
    float64 corrections do not reproduce), ``m_hat / (sqrt(v_hat) + eps)``
    plus ``weight_decay * p``, scaled by ``-lr``. Every parameter decays,
    biases included, as in optax."""

    def __init__(self, params, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        grads = [p.grad for p in self.params]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def _fit(model: torch.nn.Module, batch_loss: Callable, rng: np.random.Generator,
         train_idx: np.ndarray, batch_size: int, n_steps: int, lr: float,
         weight_decay: float, dev: torch.device, log_every: int,
         log: Callable) -> Optional[torch.Tensor]:
    """``optax.adamw(optax.cosine_decay_schedule(lr, n_steps, 0.05),
    weight_decay=weight_decay)`` over batches drawn as the JAX trainer draws
    them (``rng.choice(train_idx, size=batch_size)`` each step). Returns the
    last loss, on the device."""
    if not n_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={n_steps}.")
    opt = OptaxAdamW(model.parameters(), weight_decay)
    # every step's draw at once, in the JAX loop's order: one upload, and
    # no copy from the host inside the loop
    draws = np.stack([rng.choice(train_idx, size=batch_size) for _ in range(n_steps)])
    steps_idx = torch.from_numpy(draws).to(dev)
    loss = None
    for k in range(n_steps):
        model.zero_grad(set_to_none=True)
        loss = batch_loss(steps_idx[k])
        loss.backward()
        opt.step(cosine_decay_lr(lr, n_steps, k))
        if log_every and (k + 1) % log_every == 0:
            log(k, loss)
    return loss


def train_shift_model(
    data: dict,
    hidden: int = 128,
    steps: int = 4,
    batch_size: int = 256,
    n_steps: int = 4000,
    lr: float = 2e-3,
    seed: int = 0,
    val_frac: float = 0.05,
    log_every: int = 500,
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
    init_stats: Optional[dict] = None,
    weight_decay: float = 1e-4,
    device: DeviceLike = None,
):
    """Distill shift_rules into NMRShiftModel on ``device`` (cuda unless
    asked otherwise). Returns (model, stats, report): the trained model in
    eval mode, the ShiftStats-compatible normalization dict and the report
    with held-out ppm MAEs.

    ``init_params`` (a state dict) / ``init_stats`` warm-start from an
    existing checkpoint; the normalization statistics are then kept from it
    so the factory's denormalization stays compatible."""
    from .gnn import NMRShiftModel

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_val, val_idx, train_idx = _split(len(data["n_atoms"]), val_frac, rng)

    if init_stats is not None:
        mean_c, std_c = init_stats["mean_c"], init_stats["std_c"]
        mean_h, std_h = init_stats["mean_h"], init_stats["std_h"]
    else:
        mean_c = float(data["target_c"][data["mask_c"] > 0].mean())
        std_c = float(data["target_c"][data["mask_c"] > 0].std() + 1e-6)
        mean_h = float(data["target_h"][data["mask_h"] > 0].mean())
        std_h = float(data["target_h"][data["mask_h"] > 0].std() + 1e-6)
    stats = {"mean_c": mean_c, "std_c": std_c, "mean_h": mean_h, "std_h": std_h}

    d = _park(data, ["nodes", "edges", "n_atoms", "target_c", "mask_c", "target_h", "mask_h"], dev)
    model = _start(NMRShiftModel(hidden=hidden, steps=steps), init_params, seed, dev)

    def masked_mean(x, m):
        return (x * m).sum() / m.sum().clamp_min(1.0)

    def batch_loss(idx):
        c, h = model(*_dense(d, idx))
        tc = (d["target_c"][idx] - mean_c) / std_c
        th = (d["target_h"][idx] - mean_h) / std_h
        lc = masked_mean(F.huber_loss(c, tc, reduction="none", delta=1.0), d["mask_c"][idx].float())
        lh = masked_mean(F.huber_loss(h, th, reduction="none", delta=1.0), d["mask_h"][idx].float())
        return lc + lh

    @torch.no_grad()
    def val_mae(idx_np):
        idx = torch.from_numpy(idx_np).to(dev)
        c, h = model(*_dense(d, idx))
        err_c = (c * std_c + mean_c - d["target_c"][idx]).abs()
        err_h = (h * std_h + mean_h - d["target_h"][idx]).abs()
        return (masked_mean(err_c, d["mask_c"][idx].float()),
                masked_mean(err_h, d["mask_h"][idx].float()))

    def log(k, loss):
        mae_c, mae_h = val_mae(val_idx[:512])
        print(f"shift distill step {k+1}/{n_steps}: loss {float(loss.detach()):.4f} "
              f"val MAE 13C {float(mae_c):.2f} ppm, 1H {float(mae_h):.3f} ppm", flush=True)

    loss = _fit(model, batch_loss, rng, train_idx, batch_size, n_steps, lr, weight_decay, dev,
                log_every, log)
    mae_c, mae_h = val_mae(val_idx[:2048])
    report = {
        "val_mae_c_ppm": float(mae_c),
        "val_mae_h_ppm": float(mae_h),
        "final_loss": float(loss.detach()) if loss is not None else None,
        "n_train": int(len(train_idx)),
        "n_val": int(n_val),
        "hidden": hidden,
        "steps": steps,
        "train_steps": n_steps,
    }
    return model.eval(), stats, report


def train_ir_model(
    data: dict,
    hidden: int = 128,
    steps: int = 4,
    bins: int = 1801,
    batch_size: int = 128,
    n_steps: int = 3000,
    lr: float = 2e-3,
    seed: int = 0,
    val_frac: float = 0.05,
    log_every: int = 500,
    init_params: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = None,
):
    """Distill ir_rules into IRModel on ``device`` (cuda unless asked
    otherwise). Returns (model in eval mode, report).

    ``init_params`` (a state dict; the JAX trainer has no such argument)
    starts from given weights instead of the seeded init: for a warm start,
    and for tests that start both packages from one tree."""
    from .gnn import IRModel

    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 1)
    n_val, val_idx, train_idx = _split(len(data["n_atoms"]), val_frac, rng)

    d = _park(data, ["nodes", "edges", "n_atoms", "ir"], dev)
    model = _start(IRModel(hidden=hidden, steps=steps, bins=bins), init_params, seed, dev)

    def batch_loss(idx):
        pred = model(*_dense(d, idx))
        return torch.mean(torch.square(pred - d["ir"][idx].float() / 255.0))

    @torch.no_grad()
    def val_mae(idx_np):
        idx = torch.from_numpy(idx_np).to(dev)
        pred = model(*_dense(d, idx))
        return torch.mean(torch.abs(pred - d["ir"][idx].float() / 255.0))

    def log(k, loss):
        mae = val_mae(val_idx[:256])
        print(f"ir distill step {k+1}/{n_steps}: loss {float(loss.detach()):.5f} "
              f"val MAE {float(mae):.4f}", flush=True)

    loss = _fit(model, batch_loss, rng, train_idx, batch_size, n_steps, lr, 1e-4, dev,
                log_every, log)
    report = {
        "val_mae": float(val_mae(val_idx[:1024])),
        "final_loss": float(loss.detach()) if loss is not None else None,
        "n_train": int(len(train_idx)),
        "n_val": int(n_val),
        "hidden": hidden,
        "steps": steps,
        "bins": bins,
        "train_steps": n_steps,
    }
    return model.eval(), report


# ---------------------------------------------------------------------------
# weight files (flax's msgpack + JSON meta)
# ---------------------------------------------------------------------------

def _save(model: torch.nn.Module, meta: dict, out_dir: str, name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    write_msgpack(linear_tree(model.state_dict()), os.path.join(out_dir, f"{name}.msgpack"))
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(meta, f, indent=1)


def save_shift_weights(model: torch.nn.Module, stats: dict, report: dict, out_dir: str) -> None:
    """``nmr_shift.msgpack`` (the bytes ``flax.serialization.to_bytes`` writes
    for the trained tree) and ``nmr_shift.json`` into ``out_dir``."""
    _save(model, {"stats": stats, "report": report}, out_dir, "nmr_shift")


def save_ir_weights(model: torch.nn.Module, report: dict, out_dir: str) -> None:
    """``ir.msgpack`` and ``ir.json`` into ``out_dir``."""
    _save(model, {"report": report}, out_dir, "ir")


def _load(model: torch.nn.Module, msg_path: str, device) -> torch.nn.Module:
    model.load_state_dict(linear_params(read_msgpack(msg_path)))
    return model.eval().to(device)


def load_shift_weights(weights_dir: str = WEIGHTS_DIR, device: DeviceLike = None):
    """(NMRShiftModel on ``device``, ShiftStats) from committed weights, or None."""
    from .factory import ShiftStats
    from .gnn import NMRShiftModel

    msg = os.path.join(weights_dir, "nmr_shift.msgpack")
    meta_path = os.path.join(weights_dir, "nmr_shift.json")
    if not (os.path.exists(msg) and os.path.exists(meta_path)):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    r = meta["report"]
    model = _load(NMRShiftModel(hidden=r["hidden"], steps=r["steps"]), msg, resolve_device(device))
    s = meta["stats"]
    return model, ShiftStats(s["mean_c"], s["std_c"], s["mean_h"], s["std_h"])


def load_ir_weights(weights_dir: str = WEIGHTS_DIR, device: DeviceLike = None):
    """IRModel on ``device`` from committed weights, or None."""
    from .gnn import IRModel

    msg = os.path.join(weights_dir, "ir.msgpack")
    meta_path = os.path.join(weights_dir, "ir.json")
    if not (os.path.exists(msg) and os.path.exists(meta_path)):
        return None
    with open(meta_path) as f:
        r = json.load(f)["report"]
    return _load(IRModel(hidden=r["hidden"], steps=r["steps"], bins=r["bins"]), msg,
                 resolve_device(device))
