#!/usr/bin/env python3
"""Simulator-matched control of the reference's shipped test set, on the card.

The port's counterpart of ``scripts/control_adapted_sim_eval.py``, whose
docstring tells the experiment: the first ``--n`` molecules of the
``--split`` half of the shipped 13C/HSQC/COSY test set (``--ref-dir``) get
spectra SIMULATED on the device by the shift GNN of ``--sim-weights`` (no IR;
1H blanked unless ``--keep-1h``), and the checkpoint ``--params`` (full width)
is evaluated on them in chunks of ``--chunk-size`` with the full harness:
fan-out 128, 10 multinomial runs, 10 temperature rounds, MW filter, bf16
decoding, spectral errors simulated with the same shift weights, chunk ``ci``
seeded with ``1234 + ci``. A high score means the molecules are decodable and
the real spectra are what fails; a low one points at the molecules.

Writes the JSON summary (greedy exact, MNS exact, best tanimoto) to ``--out``
(``runs/control_adapted_sim_<split>.json`` by default). Runs on the card
unless ``--device cpu``.

    python3 scripts/torch_control_adapted_sim_eval.py --params CKPT --ref-dir DIR [--n 128]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multimodalspectraltransformer_torch.data.pipeline import REF_TESTSET_DIR  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--chunk-size", type=int, default=48)
    ap.add_argument("--split", default="adapt", choices=["adapt", "eval"])
    ap.add_argument("--keep-1h", action="store_true")
    ap.add_argument("--sim-weights",
                    default="multimodalspectraltransformer_tpu/sim/weights_sgnn",
                    help="shift-GNN weights dir used BOTH to simulate the "
                         "query spectra and to score candidates (the "
                         "simulator-matched control)")
    ap.add_argument("--out", default="",
                    help="output json path (default runs/control_adapted_sim_<split>.json); "
                         "distinct experiments must never share a filename")
    ap.add_argument("--ref-dir", default=REF_TESTSET_DIR)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from multimodalspectraltransformer_torch.data.pipeline import (load_reference_sets,
                                                                   ref_testset_split)
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.sim import distill
    from multimodalspectraltransformer_torch.sim.factory import simulate_records
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    chc, _ = load_reference_sets(args.ref_dir)
    half = [r for r in chc if ref_testset_split(r.sample_id) == args.split][: args.n]
    print(f"[control] {len(half)} {args.split}-half molecules", flush=True)

    loaded = distill.load_shift_weights(args.sim_weights, dev)
    if loaded is None:
        raise SystemExit(f"--sim-weights {args.sim_weights}: no shift weights found")
    sm, stats = loaded
    t0 = time.time()
    sims = simulate_records(
        [r.smiles for r in half], sample_ids=[r.sample_id for r in half],
        shift_model=sm, stats=stats, with_ir=False, device=dev)
    if not args.keep_1h:
        sims = [dataclasses.replace(r, h1=None) for r in sims]
    print(f"[control] simulated {len(sims)} records in {time.time()-t0:.0f}s",
          flush=True)

    model = mmt.load_model(args.params, ModelConfig(), device=dev)
    dcfg = DecodeConfig(max_len=64, fanout=128, multinom_runs=10,
                        max_temp_rounds=10, mw_filter=True,
                        compute_dtype="bfloat16")
    sim_kwargs = {"shift_model": sm, "stats": stats}

    agg: list = []
    for ci in range(0, len(sims), args.chunk_size):
        chunk = sims[ci : ci + args.chunk_size]
        t0 = time.time()
        results, summary = harness.evaluate_molecules(
            chunk, model, dcfg, seed=1234 + ci,
            simulate_errors=True, sim_kwargs=sim_kwargs, device=dev)
        agg.extend(results)
        print(f"[control] chunk {ci // args.chunk_size}: {len(chunk)} mols "
              f"{time.time()-t0:.0f}s | greedy {summary.greedy_exact:.3f} "
              f"mns {summary.mns_exact:.3f}", flush=True)

    sim_label = os.path.basename(args.sim_weights.rstrip("/"))
    out = {
        "control": "simulator-matched free-running decode "
                   f"(queries simulated by {sim_label}, same weights score "
                   "candidates; NOT the real-SGNN external benchmark)",
        "script": "scripts/torch_control_adapted_sim_eval.py",
        "split": args.split,
        "n": len(agg),
        "sim_weights": args.sim_weights,
        "spectra": f"{sim_label} (1H blanked)" if not args.keep_1h else sim_label,
        "greedy_exact": float(np.mean([r.greedy_exact for r in agg])),
        "mns_exact": float(np.mean([r.mns_exact for r in agg])),
        "best_tanimoto": float(np.mean([r.best_tanimoto for r in agg])),
        "params": args.params,
    }
    print(json.dumps(out, indent=1))
    out_path = args.out or f"runs/control_adapted_sim_{args.split}.json"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[control] wrote {out_path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
