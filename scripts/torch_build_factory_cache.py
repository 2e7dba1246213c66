#!/usr/bin/env python3
"""Build a ``cli train --factory-cache`` pickle from a corpus file, on the card.

The port's counterpart of ``scripts/build_factory_cache.py``: the data
factory (``sim.factory.simulate_records``: the trained GNNs' shifts and IR on
the device, spectrum reconstruction on the host) over a SMILES corpus in
chunks of ``--chunk`` with progress lines, sample ids ``f<index>``. Every
``--checkpoint-every`` chunks the records so far go to ``<out>.partial``, and
at the end all of them to ``<out>``, each written to a temporary name and
moved into place. The pickle holds ``{"n", "seed", "records"}``, the key that
``cli train --factory N --factory-seed S --factory-cache OUT`` (of either
package) checks. Runs on the card unless ``--device cpu``.

    python3 scripts/torch_build_factory_cache.py --corpus corpus.txt --n 200000 --seed 21 \\
        --out factory.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dump(obj, path: str) -> None:
    """``obj`` pickled to ``path`` through a temporary file and a rename, so a
    crash mid-write leaves the previous file whole."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", required=True, help="text file, one SMILES per line")
    ap.add_argument("--n", type=int, required=True,
                    help="the --factory N the cache will be used with (key check)")
    ap.add_argument("--seed", type=int, required=True,
                    help="the --factory-seed the cache will be used with (key check)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="crash-safety checkpoint cadence in chunks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    with open(args.corpus) as f:
        smiles = [ln.strip() for ln in f if ln.strip()]
    print(f"corpus: {len(smiles)} molecules from {args.corpus}", flush=True)
    if len(smiles) != args.n:
        print(f"[warn] corpus holds {len(smiles)} molecules but --n {args.n} was asserted for "
              "the cache key: a mismatched or truncated corpus would train on fewer records "
              "than requested", file=sys.stderr, flush=True)

    records = []
    t_all = time.time()
    for lo in range(0, len(smiles), args.chunk):
        chunk = smiles[lo : lo + args.chunk]
        t0 = time.time()
        recs = factory.simulate_records(chunk, sample_ids=[f"f{lo + i}" for i in range(len(chunk))],
                                        device=dev)
        records.extend(recs)
        done = lo + len(chunk)
        rate = done / (time.time() - t_all)
        print(f"factory {done}/{len(smiles)}: {len(recs)} records in {time.time() - t0:.1f}s "
              f"({rate:.1f} mol/s, ETA {(len(smiles) - done) / rate / 60:.0f} min)", flush=True)
        # every K chunks, not every chunk: re-pickling the growing list each
        # chunk is quadratic in the corpus
        if (lo // args.chunk + 1) % args.checkpoint_every == 0:
            _dump({"n": args.n, "seed": args.seed, "done": done, "records": records},
                  args.out + ".partial")

    _dump({"n": args.n, "seed": args.seed, "records": records}, args.out)
    if os.path.exists(args.out + ".partial"):
        os.remove(args.out + ".partial")
    print(f"wrote {args.out}: {len(records)} records in {(time.time() - t_all) / 60:.1f} min",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
