#!/usr/bin/env python3
"""Build the adapt-half memorization factory cache (host-side, instant).

The port's counterpart of ``scripts/r4_mem_control.py``, whose docstring tells
the experiment: the ADAPT half of the shipped 13C/HSQC/COSY test set in
``--ref-dir``, canonicalized, verbatim (its real SGNN spectra, no IR),
``--dup`` times with sample ids ``<id>_m<k>``, written as a keyed
``--factory-cache`` pickle ``{"n", "seed", "records"}`` so that a short
fine-tune memorizes them and ``torch_accuracy_report.py --ref-split adapt``
measures free-running recovery. Reads no device.

    python3 scripts/torch_r4_mem_control.py --out .cache/factory_adapt_mem.pkl --ref-dir DIR \\
        [--dup 32] [--key-seed 4242]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.chem import api as chem_api  # noqa: E402
from multimodalspectraltransformer_torch.data.pipeline import (  # noqa: E402
    REF_TESTSET_DIR,
    SampleRecord,
    load_reference_sets,
    ref_testset_split,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dup", type=int, default=32)
    ap.add_argument("--key-seed", type=int, default=4242)
    ap.add_argument("--ref-dir", default=REF_TESTSET_DIR)
    args = ap.parse_args(argv)

    chc, _ = load_reference_sets(args.ref_dir)
    adapt = []
    for r in chc:
        if ref_testset_split(r.sample_id) != "adapt":
            continue
        can = chem_api.canonicalize(r.smiles)
        if can is None:
            continue
        adapt.append(SampleRecord(r.sample_id, can, h1=r.h1, c13=r.c13,
                                  hsqc=r.hsqc, cosy=r.cosy, ir=None))
    records = []
    for d in range(args.dup):
        for r in adapt:
            records.append(SampleRecord(f"{r.sample_id}_m{d}", r.smiles, h1=r.h1, c13=r.c13,
                                        hsqc=r.hsqc, cosy=r.cosy, ir=None))
    n = len(records)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump({"n": n, "seed": args.key_seed, "records": records}, f)
    print(f"wrote {args.out}: {len(adapt)} adapt molecules x {args.dup} = {n} "
          f"records (train with --factory {n} --factory-seed {args.key_seed})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
