#!/usr/bin/env python3
"""Adapt the distilled shift GNN to the reference's SGNN simulator, on the card.

The port's counterpart of ``scripts/sgnn_adapt.py``, whose docstring gives the
reasons. The reference's test spectra come from its SGNN simulator; the only
observations of that function are the shipped test CSVs (13C/HSQC/COSY of one
set of molecules, 1H of another). This script turns half of them into
atom-level supervision:

1. SPLIT: each file's molecules go 50/50 by a stable hash of the sample id
   (``data.pipeline.ref_testset_split``); the ADAPT half trains, the EVAL half
   is only ever measured.
2. ASSIGN: the unassigned SGNN peak lists are aligned to atoms by a monotone
   many-to-one DP (``monotone_align``; sorted predictions against sorted
   peaks). HSQC H coordinates attach to atoms through their aligned 13C peak;
   the 1H lines are clustered into multiplets (``cluster_multiplets``) whose
   centroids align to symmetry-averaged predicted H shifts, skips allowed.
3. FINE-TUNE: ``sim.distill.train_shift_model`` on the device, warm-started
   from the committed shift weights (their hidden size and message steps, their
   normalization), weight decay 0, the assigned peaks as targets.
4. VALIDATE: peak-level 13C nearest-peak MAE, HSQC matched distance and 1H
   centroid MAE on the EVAL half, before and after.

The adapted weights go to ``--out`` (a directory of its own under ``runs/``
by default; the committed ``sim/weights_sgnn/`` is never written), the split
and the report (``before``/``after`` as ``eval_before``/``eval_after``, the
assignment counts, the provenance) to ``--report``. ``--ref-dir`` holds the
shipped CSVs (by default ``MMT_website/Runfolder/CSV_files`` in the
repository). Runs on the card unless ``--device cpu``.

    python3 scripts/torch_sgnn_adapt.py --ref-dir DIR [--steps 3000] [--lr 3e-4] \\
        [--out runs/sgnn_adapt/weights_sgnn] [--report runs/sgnn_adapt]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multimodalspectraltransformer_torch.chem import api as chem_api  # noqa: E402
from multimodalspectraltransformer_torch.chem.smiles import parse_smiles  # noqa: E402
from multimodalspectraltransformer_torch.data.pipeline import (  # noqa: E402
    REF_TESTSET_DIR,
    load_reference_sets,
)
from multimodalspectraltransformer_torch.data.pipeline import (  # noqa: E402
    ref_testset_split as split_of,
)
from multimodalspectraltransformer_torch.sim import distill, reconstruct  # noqa: E402
from multimodalspectraltransformer_torch.sim.factory import (  # noqa: E402
    ShiftStats,
    _predict_chunked,
    default_shift_model,
)
from multimodalspectraltransformer_torch.utils.device import resolve_device  # noqa: E402

# assignment gates: alignments farther than this from the prediction are
# treated as wrong correspondences and dropped from the training targets
GATE_C_PPM = 12.0
GATE_H_PPM = 1.2
CLUSTER_GAP_PPM = 0.03  # J=7 Hz at 400 MHz is 0.0175 ppm between lines


def monotone_align(pred_sorted: np.ndarray, peaks_sorted: np.ndarray,
                   skip_pen: float = np.inf) -> list:
    """Monotone many-to-one alignment: every prediction maps to one peak,
    peaks host >=1 prediction (or are skipped at ``skip_pen`` each, for 1H
    clusters that belong to no C-H prediction, e.g. exchangeable protons).
    Returns the per-prediction peak index (into ``peaks_sorted``), all None
    when no alignment exists. O(n*m) DP."""
    n, m = len(pred_sorted), len(peaks_sorted)
    if m == 0 or n == 0:
        return [None] * n
    INF = float("inf")
    cost = np.abs(pred_sorted[:, None] - peaks_sorted[None, :])
    f = np.full((n + 1, m + 1), INF)
    f[0][0] = 0.0
    # choice[i][j]: 0 = atom i joins peak j, 1 = atom i starts peak j,
    # 2 = peak j skipped
    choice = np.zeros((n + 1, m + 1), np.int8)
    for j in range(1, m + 1):
        if skip_pen < INF and f[0][j - 1] < INF:
            f[0][j] = f[0][j - 1] + skip_pen
            choice[0][j] = 2
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            best, arg = INF, 0
            if f[i - 1][j] < INF:
                v = f[i - 1][j] + cost[i - 1][j - 1]
                if v < best:
                    best, arg = v, 0
            if f[i - 1][j - 1] < INF:
                v = f[i - 1][j - 1] + cost[i - 1][j - 1]
                if v < best:
                    best, arg = v, 1
            if skip_pen < INF and f[i][j - 1] < INF:
                v = f[i][j - 1] + skip_pen
                if v < best:
                    best, arg = v, 2
            f[i][j] = best
            choice[i][j] = arg
    if not np.isfinite(f[n][m]):
        return [None] * n
    out: list = [None] * n
    i, j = n, m
    while i > 0 or j > 0:
        c = choice[i][j]
        if c == 2:
            j -= 1
        elif c == 1:
            out[i - 1] = j - 1
            i -= 1
            j -= 1
        else:
            out[i - 1] = j - 1
            i -= 1
    return out


def predict_all(records, model, stats, device=None):
    """Per record (record, mol, shift_c[n], shift_h[n]) with the given GNN on
    ``device``; records whose SMILES does not parse or whose graph exceeds the
    GNN's budget are left out."""
    dev = resolve_device(device)
    mols, keep = [], []
    for r in records:
        try:
            can = chem_api.canonicalize(r.smiles)
            mol = parse_smiles(can)
        except Exception:  # the JAX script skips whatever its parser refuses
            continue
        mols.append(mol)
        keep.append(r)
    compacts = [distill.featurize_compact(m) for m in mols]
    fit = [i for i, c in enumerate(compacts) if c is not None]
    outs = [None] * len(mols)
    if fit:
        for i, o in zip(fit, _predict_chunked(model, [compacts[i] for i in fit], dev)):
            outs[i] = o
    res = []
    for r, mol, o in zip(keep, mols, outs):
        if o is None:
            continue
        n = mol.num_atoms
        sc = o[0][:n] * stats.std_c + stats.mean_c
        sh = o[1][:n] * stats.std_h + stats.mean_h
        res.append((r, mol, sc, sh))
    return res


def cluster_multiplets(h1_peaks):
    """[(ppm, intensity)] -> [(centroid, total_intensity, n_lines)] by gap
    clustering (reference multiplets are rendered at 400 MHz; lines within one
    multiplet sit < ~0.02 ppm apart)."""
    pts = sorted((float(p[0]), float(p[1])) for p in h1_peaks)
    clusters = []
    cur = [pts[0]]
    for p in pts[1:]:
        if p[0] - cur[-1][0] > CLUSTER_GAP_PPM:
            clusters.append(cur)
            cur = [p]
        else:
            cur.append(p)
    clusters.append(cur)
    out = []
    for c in clusters:
        w = sum(i for _, i in c)
        if w <= 0:
            continue
        out.append((sum(s * i for s, i in c) / w, w, len(c)))
    return out


def _h_bearing_carbons(mol) -> list[int]:
    return [i for i, a in enumerate(mol.atoms) if a.symbol == "C" and mol.total_h(i) > 0]


def build_assignment_dataset(chc_records, h1_records, model, stats, max_nodes: int = 64,
                             device=None):
    """ADAPT-half records -> compact GNN training arrays with SGNN-assigned
    per-atom targets. Returns (data dict, counts dict)."""
    nodes, edges, n_atoms = [], [], []
    tcs, mcs, ths, mhs = [], [], [], []
    info = {"mols": 0, "c_labels": 0, "h_hsqc_labels": 0, "h_clust_labels": 0,
            "c_gated": 0, "h_gated": 0, "skipped": 0}

    def add_record(mol, t_c, m_c, t_h, m_h):
        compact = distill.featurize_compact(mol, max_nodes)
        if compact is None:
            info["skipped"] += 1
            return
        nodes.append(compact[0])
        edges.append(compact[1])
        n_atoms.append(compact[2])
        tcs.append(t_c)
        mcs.append(m_c)
        ths.append(t_h)
        mhs.append(m_h)
        info["mols"] += 1

    def blank():
        return (np.zeros(max_nodes, np.float32), np.zeros(max_nodes, np.uint8),
                np.zeros(max_nodes, np.float32), np.zeros(max_nodes, np.uint8))

    # --- 13C/HSQC file ---------------------------------------------------
    for r, mol, sc, sh in predict_all(chc_records, model, stats, device):
        if mol.num_atoms > max_nodes:
            info["skipped"] += 1
            continue
        t_c, m_c, t_h, m_h = blank()
        carbons = [i for i, a in enumerate(mol.atoms) if a.symbol == "C"]
        if r.c13:
            peaks = np.array(sorted(float(x) for x in r.c13))
            order = sorted(carbons, key=lambda i: sc[i])
            if len(peaks) <= len(order):
                assign = monotone_align(np.array([sc[i] for i in order]), peaks)
                for k, i in enumerate(order):
                    j = assign[k]
                    if j is None:
                        continue
                    if abs(sc[i] - peaks[j]) > GATE_C_PPM:
                        info["c_gated"] += 1
                        continue
                    t_c[i] = peaks[j]
                    m_c[i] = 1
                    info["c_labels"] += 1
        if r.hsqc and m_c.any():
            # each HSQC H coordinate goes to the atoms whose assigned 13C peak
            # matches its C coordinate
            by_peak: dict = {}
            for i in carbons:
                if m_c[i] and mol.total_h(i) > 0:
                    by_peak.setdefault(round(float(t_c[i]), 4), []).append(i)
            contrib: dict = {}
            for p in r.hsqc:
                hv, cv = float(p[0]), float(p[1])
                if not by_peak:
                    break
                keys = np.array(list(by_peak.keys()))
                k = keys[np.abs(keys - cv).argmin()]
                if abs(k - cv) > 0.5:
                    continue
                for i in by_peak[k]:
                    contrib.setdefault(i, []).append(hv)
            for i, hs in contrib.items():
                hv = float(np.mean(hs))
                if abs(sh[i] - hv) > GATE_H_PPM:
                    info["h_gated"] += 1
                    continue
                t_h[i] = hv
                m_h[i] = 1
                info["h_hsqc_labels"] += 1
        if m_c.any() or m_h.any():
            add_record(mol, t_c, m_c, t_h, m_h)
        else:
            info["skipped"] += 1

    # --- 1H-only file ----------------------------------------------------
    for r, mol, sc, sh in predict_all(h1_records, model, stats, device):
        if not r.h1 or mol.num_atoms > max_nodes:
            info["skipped"] += 1
            continue
        t_c, m_c, t_h, m_h = blank()
        hb = _h_bearing_carbons(mol)
        if not hb:
            info["skipped"] += 1
            continue
        # symmetry-averaged prediction per environment (one multiplet per
        # symmetry class in the reference's generator)
        avg = reconstruct._sym_averaged(mol, sh, hb)
        env: dict = {}
        for i in hb:
            env.setdefault(round(avg[i], 6), []).append(i)
        env_shifts = np.array(sorted(env.keys()))
        centroids = np.array([c[0] for c in cluster_multiplets(r.h1)])
        # skips allowed: extra centroids (diastereotopic twins, exchangeable
        # protons) stay unassigned at skip_pen each
        assign = monotone_align(env_shifts, centroids, skip_pen=0.6)
        for k, es in enumerate(env_shifts):
            j = assign[k]
            if j is None:
                continue
            hv = float(centroids[j])
            if abs(es - hv) > GATE_H_PPM:
                info["h_gated"] += 1
                continue
            for i in env[round(float(es), 6)]:
                t_h[i] = hv
                m_h[i] = 1
                info["h_clust_labels"] += 1
        if m_h.any():
            add_record(mol, t_c, m_c, t_h, m_h)
        else:
            info["skipped"] += 1

    data = {
        "nodes": np.stack(nodes),
        "edges": np.stack(edges),
        "n_atoms": np.asarray(n_atoms, np.int32),
        "target_c": np.stack(tcs),
        "mask_c": np.stack(mcs),
        "target_h": np.stack(ths),
        "mask_h": np.stack(mhs),
    }
    return data, info


def eval_metrics(records, model, stats, device=None) -> dict:
    """Peak-level agreement with SGNN on clean records: 13C NN-MAE of the
    reference peaks to the reconstructed consolidated prediction, HSQC matched
    distance, 1H multiplet-centroid NN-MAE."""
    c_err, h_err, hsqc_err = [], [], []
    for r, mol, sc, sh in predict_all(records, model, stats, device):
        shifts = reconstruct.AtomShifts(sc, sh)
        if r.c13:
            mine = np.array(reconstruct.reconstruct_13c(mol, shifts))
            if len(mine):
                for x in r.c13:
                    c_err.append(float(np.abs(mine - float(x)).min()))
        if r.hsqc:
            mine = np.array(reconstruct.reconstruct_hsqc(mol, shifts))
            if len(mine):
                for p in r.hsqc:
                    d = np.abs(mine[:, 1] - float(p[1])) + 10.0 * np.abs(mine[:, 0] - float(p[0]))
                    hsqc_err.append(float(d.min()))
        if r.h1:
            cents = np.array([c[0] for c in cluster_multiplets(r.h1)])
            hb = _h_bearing_carbons(mol)
            if hb:
                pred = np.array(sorted({round(v, 6) for v in
                                        reconstruct._sym_averaged(mol, sh, hb).values()}))
                for x in cents:
                    h_err.append(float(np.abs(pred - x).min()))
    out = {}
    if c_err:
        out["c13_nn_mae_ppm"] = float(np.mean(c_err))
        out["c13_nn_p90_ppm"] = float(np.percentile(c_err, 90))
    if hsqc_err:
        out["hsqc_match_dist"] = float(np.mean(hsqc_err))
    if h_err:
        out["h1_centroid_nn_mae_ppm"] = float(np.mean(h_err))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref-dir", default=REF_TESTSET_DIR)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("runs", "sgnn_adapt", "weights_sgnn"))
    ap.add_argument("--report", default=os.path.join("runs", "sgnn_adapt"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    chc, h1 = load_reference_sets(args.ref_dir)
    chc_adapt = [r for r in chc if split_of(r.sample_id) == "adapt"]
    chc_eval = [r for r in chc if split_of(r.sample_id) == "eval"]
    h1_adapt = [r for r in h1 if split_of(r.sample_id) == "adapt"]
    h1_eval = [r for r in h1 if split_of(r.sample_id) == "eval"]
    print(f"[adapt] split: CHC {len(chc_adapt)}/{len(chc_eval)} "
          f"1H {len(h1_adapt)}/{len(h1_eval)} (adapt/eval)", flush=True)

    base = default_shift_model(dev)
    if base is None:
        print("[adapt] no committed base weights — aborting", file=sys.stderr)
        return 1
    model0, stats0 = base

    data, info = build_assignment_dataset(chc_adapt, h1_adapt, model0, stats0, device=dev)
    print(f"[adapt] assignment dataset: {info}", flush=True)

    before = {
        "chc_eval": eval_metrics(chc_eval, model0, stats0, dev),
        "h1_eval": eval_metrics(h1_eval, model0, stats0, dev),
    }
    print(f"[adapt] BEFORE: {json.dumps(before)}", flush=True)

    with open(os.path.join(distill.WEIGHTS_DIR, "nmr_shift.json")) as f:
        meta = json.load(f)
    hid, gsteps = meta["report"]["hidden"], meta["report"]["steps"]

    model, stats, report = distill.train_shift_model(
        data, hidden=hid, steps=gsteps,
        batch_size=args.batch_size, n_steps=args.steps, lr=args.lr,
        seed=args.seed, val_frac=0.08, log_every=200,
        weight_decay=0.0,
        init_params=model0.state_dict(),
        init_stats={"mean_c": stats0.mean_c, "std_c": stats0.std_c,
                    "mean_h": stats0.mean_h, "std_h": stats0.std_h},
        device=dev)

    stats_t = ShiftStats(**stats)
    after = {
        "chc_eval": eval_metrics(chc_eval, model, stats_t, dev),
        "h1_eval": eval_metrics(h1_eval, model, stats_t, dev),
    }
    print(f"[adapt] AFTER: {json.dumps(after)}", flush=True)

    report.update({
        "provenance": "sgnn_adapt fine-tune on ADAPT halves of the shipped "
                      "reference test CSVs (see scripts/torch_sgnn_adapt.py)",
        "assignment": info,
        "eval_before": before,
        "eval_after": after,
    })
    distill.save_shift_weights(model, stats, report, out_dir=args.out)
    os.makedirs(args.report, exist_ok=True)
    with open(os.path.join(args.report, "split.json"), "w") as f:
        json.dump({
            "chc_adapt": [r.sample_id for r in chc_adapt],
            "chc_eval": [r.sample_id for r in chc_eval],
            "h1_adapt": [r.sample_id for r in h1_adapt],
            "h1_eval": [r.sample_id for r in h1_eval],
        }, f)
    with open(os.path.join(args.report, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[adapt] saved adapted weights to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
