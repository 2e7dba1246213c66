#!/usr/bin/env python3
"""Build the ZC2 mixture factory cache: zinclike corpus + adapt-half reals.

The port's counterpart of ``scripts/build_mixture_corpus.py``, whose
docstring tells the experiment: every record of the ``--zc`` cache (the
fragment-recombination corpus, simulated) plus the adapt-half molecules of
the ``--mem`` cache (``torch_r4_mem_control.py``'s; its uniques recovered by
the sample id before ``_m``), ``--dup`` times with ids ``<id>_x<k>``, all
shuffled by ``random.Random(--key-seed)`` so that the validation tail mixes
chemotypes, and written as a keyed ``--factory-cache`` pickle. Both inputs
are read by ``data.pipeline.load_records_pickle``: a pickle the JAX package
wrote needs no JAX. Reads no device.

    python3 scripts/torch_build_mixture_corpus.py --zc .cache/factory_zinc.pkl \\
        --mem .cache/factory_adapt_mem.pkl --dup 64 --out .cache/factory_zc2.pkl --key-seed 777
"""
from __future__ import annotations

import argparse
import os
import pickle
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.data.pipeline import (  # noqa: E402
    SampleRecord,
    load_records_pickle,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--zc", default=".cache/factory_zinc.pkl")
    ap.add_argument("--mem", default=".cache/factory_adapt_mem.pkl")
    ap.add_argument("--dup", type=int, default=64,
                    help="adapt-half oversampling (mem cache already holds "
                         "32 dups; this is the TOTAL target multiple)")
    ap.add_argument("--out", default=".cache/factory_zc2.pkl")
    ap.add_argument("--key-seed", type=int, default=777)
    args = ap.parse_args(argv)

    zc = load_records_pickle(args.zc)["records"]
    mem = load_records_pickle(args.mem)["records"]
    # mem holds uniques x dup with _m<d> suffixes; recover the uniques
    uniq = {}
    for r in mem:
        base = r.sample_id.split("_m")[0]
        if base not in uniq:
            uniq[base] = r
    reals = []
    for d in range(args.dup):
        for base, r in uniq.items():
            reals.append(SampleRecord(f"{base}_x{d}", r.smiles, h1=r.h1, c13=r.c13,
                                      hsqc=r.hsqc, cosy=r.cosy, ir=r.ir))
    records = list(zc) + reals
    rng = random.Random(args.key_seed)
    rng.shuffle(records)  # val split is the tail: keep it chemotype-mixed
    n = len(records)
    with open(args.out, "wb") as f:
        pickle.dump({"n": n, "seed": args.key_seed, "records": records}, f)
    print(f"wrote {args.out}: {len(zc)} zinclike + {len(uniq)} adapt uniques "
          f"x {args.dup} = {n} records "
          f"(train with --factory {n} --factory-seed {args.key_seed})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
