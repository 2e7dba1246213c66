"""The simulated-data factory: SMILES -> predicted shifts -> spectra.

Counterpart of the JAX package's ``sim/factory.py``: filter the SMILES
(invalid, disconnected, H-less, MW > 550), predict 13C/1H shifts and IR with
the committed GNNs in chunks of 256 molecules padded to 64 nodes (on the
device), and reconstruct 1H/13C/HSQC/COSY peak lists on the host. Without
GNN weights the rule teachers (``shift_rules``, ``ir_rules``) are used.
``export_reference_csvs`` writes records in the reference's CSV layout.
"""

from __future__ import annotations

import csv
import os
import sys
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..chem import api as chem
from ..chem.smiles import Mol, parse_smiles
from ..data.pipeline import SampleRecord
from ..utils.device import DeviceLike, resolve_device
from . import reconstruct, shift_rules
from .reconstruct import AtomShifts

MAX_MW = 550.0  # reference SGNN_size_filter


def filter_smiles(smiles_list: Sequence[str]) -> list[tuple[int, str]]:
    """Reference run_sgnn filters (`data_generation_v15_4.py:63-103`):
    valid, connected, has hydrogens, MW <= 550."""
    keep = []
    for idx, smi in enumerate(smiles_list):
        can = chem.canonicalize(smi)
        if can is None or "." in can:
            continue
        mw = chem.mol_wt(can)
        if mw is None or mw > MAX_MW:
            continue
        try:
            mol = parse_smiles(can)
        except Exception:
            continue
        if not any(mol.total_h(i) for i in range(mol.num_atoms)):
            continue
        keep.append((idx, can))
    return keep


# ---------------------------------------------------------------------------
# Empirical shift model (Pretsch/Grant-Paul additivity rules, sim.shift_rules)
# ---------------------------------------------------------------------------

def empirical_shifts(mol: Mol) -> AtomShifts:
    """13C/1H shifts from first-party additivity increment rules
    (`sim.shift_rules.predict_shifts`; ~1-3 ppm 13C / ~0.1-0.3 ppm 1H on
    common organics). The teacher for the trained `NMRShiftModel` and the
    standalone default when no trained GNN weights are supplied."""
    return shift_rules.predict_shifts(mol)


# ---------------------------------------------------------------------------
# GNN-backed prediction
# ---------------------------------------------------------------------------

@dataclass
class ShiftStats:
    """Denormalization statistics (reference `load_std_mean`,
    `sgnn_code_pl_v15_4.py:417-425`)."""

    mean_c: float = 95.0
    std_c: float = 50.0
    mean_h: float = 4.0
    std_h: float = 2.0


_defaults: dict = {}  # (kind, device) -> loaded model (or None when absent)


def default_shift_model(device: DeviceLike = None):
    """(NMRShiftModel, ShiftStats) from the committed weights, or None."""
    dev = resolve_device(device)
    key = ("shift", str(dev))
    if key not in _defaults:
        from . import distill

        _defaults[key] = distill.load_shift_weights(device=dev)
    return _defaults[key]


def default_ir_model(device: DeviceLike = None):
    dev = resolve_device(device)
    key = ("ir", str(dev))
    if key not in _defaults:
        from . import distill

        _defaults[key] = distill.load_ir_weights(device=dev)
    return _defaults[key]


@torch.no_grad()
def _predict_chunked(model, compacts, device, chunk: int = 256, max_nodes: int = 64):
    """Chunked GNN apply on the device over compact graphs; returns one
    tuple of numpy outputs per molecule."""
    from .distill import densify_batch

    outs = [None] * len(compacts)
    for s in range(0, len(compacts), chunk):
        sel = list(range(s, min(s + chunk, len(compacts))))
        pad = sel + [sel[-1]] * (chunk - len(sel))  # one batch shape for every chunk
        nodes = torch.from_numpy(np.stack([compacts[i][0] for i in pad])).to(device)
        edges = torch.from_numpy(np.stack([compacts[i][1] for i in pad])).to(device)
        n_at = torch.tensor([compacts[i][2] for i in pad], dtype=torch.int32, device=device)
        res = model(*densify_batch(nodes, edges, n_at, max_nodes))
        res = [r.float().cpu().numpy() for r in (res if isinstance(res, tuple) else (res,))]
        for b, i in enumerate(sel):
            outs[i] = tuple(r[b] for r in res)
    return outs


def simulate_records(
    smiles_list: Sequence[str],
    sample_ids: Optional[Sequence[str]] = None,
    shift_model=None,
    ir_model=None,
    stats: Optional["ShiftStats"] = None,
    max_nodes: int = 64,
    use_default_models: bool = True,
    with_ir: bool = True,
    device: DeviceLike = None,
) -> list[SampleRecord]:
    """SMILES -> SampleRecords with 1H/13C/HSQC/COSY (+IR).

    Model resolution per predictor: an explicitly passed model; else the
    committed distilled GNN weights; else the rule teachers."""
    dev = resolve_device(device)
    kept = filter_smiles(smiles_list)
    if sample_ids is None:
        sample_ids = [str(i) for i in range(len(smiles_list))]

    from .distill import featurize_compact

    mols, metas, compacts = [], [], []
    n_oversized = 0
    for idx, can in kept:
        mol = parse_smiles(can)
        compact = featurize_compact(mol, max_nodes)
        if compact is None:
            n_oversized += 1
            continue
        mols.append(mol)
        metas.append((sample_ids[idx], can))
        compacts.append(compact)
    if n_oversized:
        print(
            f"[sim.factory] dropped {n_oversized} molecule(s) exceeding the GNN "
            f"featurization budget (> {max_nodes} atoms or > 96 bonds)",
            file=sys.stderr, flush=True,
        )
    if not mols:
        return []

    stats = stats or ShiftStats()
    if shift_model is None and use_default_models:
        d = default_shift_model(dev)
        if d is not None:
            shift_model, stats = d
    if shift_model is not None:
        outs = _predict_chunked(shift_model, compacts, dev, max_nodes=max_nodes)
        shifts = [
            AtomShifts(o[0][: m.num_atoms] * stats.std_c + stats.mean_c,
                       o[1][: m.num_atoms] * stats.std_h + stats.mean_h)
            for m, o in zip(mols, outs)
        ]
    else:
        shifts = [empirical_shifts(m) for m in mols]

    ir_specs: Optional[list] = None
    if with_ir:
        if ir_model is None and use_default_models:
            ir_model = default_ir_model(dev)
        if ir_model is not None:
            ir_specs = [o[0] for o in _predict_chunked(ir_model, compacts, dev, max_nodes=max_nodes)]
        else:
            from . import ir_rules

            ir_specs = [ir_rules.predict_ir(m) for m in mols]

    records = []
    for k, (mol, sh, (sid, can)) in enumerate(zip(mols, shifts, metas)):
        h1 = reconstruct.reconstruct_1h(mol, sh)
        c13 = reconstruct.reconstruct_13c(mol, sh)
        hsqc = reconstruct.reconstruct_hsqc(mol, sh)
        cosy = reconstruct.reconstruct_cosy(mol, sh)
        records.append(
            SampleRecord(
                sid, can,
                h1=[list(p) for p in h1] or None,
                c13=list(c13) or None,
                hsqc=[list(p) for p in hsqc] or None,
                cosy=[list(p) for p in cosy] or None,
                ir=ir_specs[k] if ir_specs is not None else None,
            )
        )
    return records


def export_reference_csvs(records: Sequence[SampleRecord], out_dir: str, run_id: str = "0") -> dict[str, str]:
    """Write the 4 per-modality CSVs in the reference's on-disk format
    (`data_generation_v15_4.py:745-757`) + per-sample IR CSVs, byte for byte
    what the JAX package's pandas writer produces: minimal quoting, ``\\n``
    line ends, floats as numpy prints them, NaN as an empty field."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for key, attr in (("1H", "h1"), ("13C", "c13"), ("HSQC", "hsqc"), ("COSY", "cosy")):
        rows = [[r.smiles, str(getattr(r, attr)), r.sample_id]
                for r in records if getattr(r, attr) is not None]
        path = os.path.join(out_dir, f"data_{key}_{run_id}.csv")
        _write_csv(path, ["SMILES", "shifts", "sample-id"] if rows else [], rows)
        paths[key] = path
    ir_dir = os.path.join(out_dir, "IR_data")
    os.makedirs(ir_dir, exist_ok=True)
    for r in records:
        if r.ir is not None:
            values = np.asarray(r.ir).reshape(-1)
            rows = [["" if np.isnan(v) else str(v)] if values.dtype.kind == "f" else [str(v)]
                    for v in values]
            _write_csv(os.path.join(ir_dir, f"{r.sample_id}.csv"), ["spectra"], rows)
    paths["IR"] = ir_dir
    return paths


def _write_csv(path: str, header: list, rows: list) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)
