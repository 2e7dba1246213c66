#!/usr/bin/env python3
"""Reproducible recipe for the round-3 phase-2 training corpus.

The port's counterpart of ``scripts/make_r3_corpus.py``, whose docstring
gives the reasons: the 200k seed-21 base corpus plus two 50k banded slabs
(seed 31 in 80-250 Da, seed 32 in 250-350 Da) from the port's
``data.molrandom.random_corpus``, merged in that order with later duplicates
dropped, one SMILES a line. The same seeds give the JAX script's corpus, line
for line. Host only.

    python3 scripts/torch_make_r3_corpus.py --out corpus_r3_300k.txt
Then simulate it on the card:
    python3 scripts/torch_build_factory_cache.py --corpus corpus_r3_300k.txt \\
        --n <printed count> --seed 3133 --out factory_r3_300k.pkl
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLABS = (
    # (n, seed, min_mw, max_mw): seed-21 200k is the round-2 base corpus;
    # the two 50k slabs stratify the bands the accuracy report flagged.
    (200_000, 21, 80.0, 550.0),
    (50_000, 31, 80.0, 250.0),
    (50_000, 32, 250.0, 350.0),
)


def build(progress: bool = True) -> list[str]:
    from multimodalspectraltransformer_torch.data import molrandom

    seen: set[str] = set()
    out: list[str] = []
    for n, seed, lo, hi in SLABS:
        t0 = time.time()
        slab = molrandom.random_corpus(n, seed=seed, min_mw=lo, max_mw=hi)
        fresh = [s for s in slab if s not in seen]
        seen.update(fresh)
        out.extend(fresh)
        if progress:
            print(
                f"slab seed={seed} band=[{lo:.0f},{hi:.0f}]: {len(slab)} drawn, "
                f"{len(fresh)} new ({time.time()-t0:.0f}s) -> total {len(out)}",
                flush=True,
            )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    corpus = build()
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(corpus) + "\n")
    os.replace(tmp, args.out)
    print(f"wrote {args.out}: {len(corpus)} molecules", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
