#!/usr/bin/env python3
"""Chunked batch-evaluation sweep of the PyTorch/CUDA port.

The port's counterpart of ``scripts/eval_sweep.py``: the molecules of
``--smiles`` (a txt or csv file, simulated on the device) or ``--synthetic
N`` fixtures go through the full evaluation harness in chunks of
``--chunk-size``, chunk ``ci`` seeded with ``--seed + ci``. Each chunk
writes ``<out>/chunk_NNNN.json`` (per-molecule results and the chunk's
summary) under a digest of its molecules, the checkpoint (``--params``, or
the init seed) and the decoding settings; a rerun skips every chunk whose
digest matches (content-addressed resume; the key ends in ``.torch``, so a
chunk the JAX script wrote is computed again). ``--shard s --num-shards k``
runs the chunks ``ci % k == s`` and writes ``summary_shard{s}.json``; once
every shard's summary exists, the merged ``summary.json`` is written (greedy
exact, MNS top-rank exact, mean tanimoto, mols/s). Runs on the card unless
``--device cpu``.

    python3 scripts/torch_eval_sweep.py --smiles mols.txt --out sweep/ --chunk-size 50 \\
        --params weights/mmt_r4_phase3.msgpack.gz [--shard 0 --num-shards 4] [--synthetic 1000]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smiles", default="", help="txt/csv of SMILES (or use --synthetic)")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--chunk-size", type=int, default=50)
    p.add_argument("--params", default="")
    p.add_argument("--small", action="store_true")
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--fanout", type=int, default=128)
    p.add_argument("--multinom-runs", type=int, default=10)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--no-sim-errors", action="store_true")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def run_key(args) -> str:
    """What a chunk's result depends on besides its molecules: the
    checkpoint and the decoding settings."""
    if args.params:
        with open(args.params, "rb") as f:
            params_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    else:
        params_hash = f"init{args.seed}"
    return (f"{params_hash}#f{args.fanout}.m{args.multinom_runs}.r{args.rounds}"
            f".l{args.max_len}.s{int(not args.no_sim_errors)}.torch")


def shard_summary(payloads: list) -> dict:
    mols = [m for p in payloads for m in p["molecules"]]
    wall = sum(p["wall_s"] for p in payloads)
    return {
        "n": len(mols),
        "greedy_exact": sum(m["greedy_exact"] for m in mols) / len(mols),
        "mns_exact": sum(m["mns_exact"] for m in mols) / len(mols),
        "mean_best_tanimoto": sum(m["best_tanimoto"] for m in mols) / len(mols),
        "mean_greedy_tanimoto": sum(m["greedy_tanimoto"] for m in mols) / len(mols),
        "total_wall_s": wall,
        "mols_per_sec": len(mols) / max(wall, 1e-9),
    }


def merged_summary(shards: list) -> dict:
    total_n = sum(s["n"] for s in shards)
    out = {"n": total_n, "num_shards": len(shards)}
    for key in ("greedy_exact", "mns_exact", "mean_best_tanimoto", "mean_greedy_tanimoto"):
        out[key] = sum(s[key] * s["n"] for s in shards) / total_n
    out["total_wall_s"] = sum(s["total_wall_s"] for s in shards)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)

    from multimodalspectraltransformer_torch.cli import _read_smiles
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        records = dp.synthetic_dataset(args.synthetic, seed=args.seed)
    elif args.smiles:
        records = factory.simulate_records(_read_smiles(args.smiles), device=dev)
    else:
        raise SystemExit("one of --smiles FILE or --synthetic N is required")
    print(f"[sweep] {len(records)} molecules", flush=True)

    mcfg = ModelConfig.small() if args.small else ModelConfig()
    model = (mmt.load_model(args.params, mcfg, device=dev) if args.params
             else mmt.init_model(mcfg, args.seed, dev))
    dcfg = DecodeConfig(max_len=args.max_len, fanout=args.fanout,
                        multinom_runs=args.multinom_runs, max_temp_rounds=args.rounds)

    chunks = [records[i : i + args.chunk_size] for i in range(0, len(records), args.chunk_size)]
    key = run_key(args)
    payloads = []
    for ci, chunk in enumerate(chunks):
        if ci % args.num_shards != args.shard:
            continue
        path = os.path.join(args.out, f"chunk_{ci:04d}.json")
        digest = hashlib.sha256(("|".join(r.smiles for r in chunk) + "#" + key).encode()
                                ).hexdigest()[:16]
        if os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("digest") == digest:
                print(f"[sweep] chunk {ci} done, skipping", flush=True)
                payloads.append(prev)
                continue
        t0 = time.time()
        results, summary = harness.evaluate_molecules(
            chunk, model, dcfg, seed=args.seed + ci, simulate_errors=not args.no_sim_errors,
            device=dev)
        payload = {
            "chunk": ci, "digest": digest, "wall_s": time.time() - t0,
            "summary": dataclasses.asdict(summary),
            "molecules": [{"target": r.target, "greedy": r.greedy, "greedy_exact": r.greedy_exact,
                           "greedy_tanimoto": r.greedy_tanimoto, "mns_exact": r.mns_exact,
                           "best_tanimoto": r.best_tanimoto,
                           "corr_sampling_prob": r.corr_sampling_prob,
                           "n_candidates": len(r.candidates)} for r in results],
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        payloads.append(payload)
        print(f"[sweep] chunk {ci}: {len(results)} mols in {payload['wall_s']:.1f}s | "
              f"greedy_exact={summary.greedy_exact:.3f} mns_exact={summary.mns_exact:.3f}",
              flush=True)

    if any(p["molecules"] for p in payloads):
        agg = shard_summary(payloads)
        with open(os.path.join(args.out, f"summary_shard{args.shard}.json"), "w") as f:
            json.dump(agg, f, indent=2)
        print("[sweep] " + json.dumps(agg), flush=True)

    # every shard's summary present: merge them into summary.json
    shard_files = [os.path.join(args.out, f"summary_shard{s}.json") for s in range(args.num_shards)]
    if all(os.path.exists(p) for p in shard_files):
        shards = []
        for p in shard_files:
            with open(p) as f:
                shards.append(json.load(f))
        merged = merged_summary(shards)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(merged, f, indent=2)
        print("[sweep] all shards done: " + json.dumps(merged), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
