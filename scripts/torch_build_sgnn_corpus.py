#!/usr/bin/env python3
"""Build the SGNN-adapted training corpus, simulated on the card.

The port's counterpart of ``scripts/build_sgnn_corpus.py``. The mixture is
written as a keyed ``--factory-cache`` pickle ``{"n", "seed", "records"}`` for
``cli train`` (of either package):

1. ADAPTED-SIM records: the first ``--n`` corpus SMILES within ``[--mw-lo,
   --mw-hi]`` Da, simulated through the SGNN-adapted shift GNN (``--weights``,
   from ``scripts/torch_sgnn_adapt.py``; the committed ``sim/weights_sgnn/`` by
   default) in chunks of ``--chunk`` on the device, without IR (the shipped
   test CSVs carry none); sample ids ``a<index>``.
2. REAL SGNN records: the ADAPT halves of the shipped test CSVs in
   ``--ref-dir``, canonicalized, verbatim, ``--real-dup`` times (ids
   ``<id>_d<k>``). Every shipped molecule, of either half, is excluded from
   the simulated slice and the anchor slice by canonical SMILES.
3. ORIGINAL-DOMAIN slice: the first ``--orig-frac * --n`` records of the
   ``--orig-cache`` pickle (the JAX package's or the port's, read without
   JAX by ``data.pipeline.load_records_pickle``) to anchor against drift.

Runs on the card unless ``--device cpu``.

    python3 scripts/torch_build_sgnn_corpus.py --out factory_sgnn.pkl --ref-dir DIR \\
        [--n 120000] [--real-dup 8] [--orig-frac 0.2] [--key-seed 777]

Then:
    cli train --factory <printed total> --factory-seed 777 --factory-cache factory_sgnn.pkl ...
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multimodalspectraltransformer_torch.data.pipeline import REF_TESTSET_DIR  # noqa: E402

SGNN_WEIGHTS = os.path.join(REPO, "multimodalspectraltransformer_tpu", "sim", "weights_sgnn")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", default="/tmp/corpus_r3_300k.txt",
                    help="source SMILES, one per line")
    ap.add_argument("--orig-cache", default="/tmp/factory_r3_300k.pkl",
                    help="keyed pickle of original-domain records for the anchor slice "
                         "(empty to skip)")
    ap.add_argument("--weights", default=SGNN_WEIGHTS)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=120000, help="adapted-sim record count")
    ap.add_argument("--mw-lo", type=float, default=200.0)
    ap.add_argument("--mw-hi", type=float, default=400.0)
    ap.add_argument("--real-dup", type=int, default=8)
    ap.add_argument("--orig-frac", type=float, default=0.2,
                    help="original-domain anchor records as a fraction of --n")
    ap.add_argument("--key-seed", type=int, default=777)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--ref-dir", default=REF_TESTSET_DIR)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from multimodalspectraltransformer_torch.chem import api as chem_api
    from multimodalspectraltransformer_torch.data.pipeline import (SampleRecord,
                                                                   load_records_pickle,
                                                                   load_reference_sets,
                                                                   ref_testset_split)
    from multimodalspectraltransformer_torch.sim import distill
    from multimodalspectraltransformer_torch.sim.factory import simulate_records
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    adapted = distill.load_shift_weights(args.weights, dev)
    if adapted is None:
        print(f"no adapted weights at {args.weights} — run torch_sgnn_adapt.py first",
              file=sys.stderr)
        return 1
    shift_model, stats = adapted

    # --- reference molecules: adapt halves join the mixture, eval halves
    # are excluded from everything
    chc, h1 = load_reference_sets(args.ref_dir)
    real_adapt, excluded = [], set()
    for r in chc + h1:
        can = chem_api.canonicalize(r.smiles)
        if can is None:
            continue
        excluded.add(can)
        if ref_testset_split(r.sample_id) == "adapt":
            real_adapt.append(SampleRecord(r.sample_id, can, h1=r.h1, c13=r.c13,
                                           hsqc=r.hsqc, cosy=r.cosy, ir=None))

    # --- adapted-sim slice
    with open(args.corpus) as f:
        src = [ln.strip() for ln in f if ln.strip()]
    picked = []
    nat = chem_api._native()
    for smi in src:
        if len(picked) >= args.n:
            break
        mw = nat.mol_wt(smi) if nat is not None else chem_api.mol_wt(smi)
        if mw is None or not (args.mw_lo <= mw <= args.mw_hi):
            continue
        if smi in excluded:
            continue
        picked.append(smi)
    print(f"[sgnn-corpus] {len(picked)} corpus SMILES in "
          f"[{args.mw_lo},{args.mw_hi}] Da (asked {args.n}); "
          f"{len(real_adapt)} real adapt records", flush=True)

    records = []
    t0 = time.time()
    for s in range(0, len(picked), args.chunk):
        chunk = picked[s:s + args.chunk]
        recs = simulate_records(
            chunk, sample_ids=[f"a{s + i}" for i in range(len(chunk))],
            shift_model=shift_model, stats=stats, with_ir=False, device=dev)
        records.extend(recs)
        done = s + len(chunk)
        rate = done / max(time.time() - t0, 1e-9)
        print(f"[sgnn-corpus] simulated {done}/{len(picked)} "
              f"({rate:.0f} mol/s)", flush=True)

    # --- real target-domain records, duplicated
    for d in range(args.real_dup):
        for r in real_adapt:
            records.append(SampleRecord(f"{r.sample_id}_d{d}", r.smiles, h1=r.h1,
                                        c13=r.c13, hsqc=r.hsqc, cosy=r.cosy, ir=None))

    # --- original-domain anchor slice
    n_orig = int(args.n * args.orig_frac)
    if n_orig and args.orig_cache and os.path.exists(args.orig_cache):
        cached = load_records_pickle(args.orig_cache)
        orig = cached["records"] if isinstance(cached, dict) else cached
        kept = [r for r in orig if r.smiles not in excluded][:n_orig]
        records.extend(kept)
        print(f"[sgnn-corpus] + {len(kept)} original-domain anchor records",
              flush=True)

    payload = {"n": len(records), "seed": args.key_seed, "records": records}
    tmp = args.out + ".partial"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, args.out)
    print(f"[sgnn-corpus] wrote {len(records)} records to {args.out} "
          f"(--factory {len(records)} --factory-seed {args.key_seed})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
