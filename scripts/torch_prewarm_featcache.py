#!/usr/bin/env python3
"""Pre-warm the featurized-dataset cache (``MMT_FEATURE_CACHE``) of the
port's ``cli train``.

The port's counterpart of ``scripts/prewarm_featcache.py``: builds the
training loader exactly as ``cli train`` does with the same flags (the
records of ``--factory N`` from ``--factory-cache``, or simulated on the
device and written there; the split off of ``--val-n``; the ``--augment``
expansion; the same featurize options), so its features digest is the one
that ``cli train --feature-cache DIR`` looks up, and writes
``DIR/mmt_features_<digest>.npz``. The featurization is host work, so it can
run beside a job on the card; a run of ``cli train`` with the same flags then
starts stepping at once. Runs on the card unless ``--device cpu``.

    python3 scripts/torch_prewarm_featcache.py --factory 291006 --factory-seed 3133 \\
        --factory-cache factory_r3_300k.pkl --val-n 1000 --augment 2 --feature-cache featcache_r3
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--factory", type=int, required=True)
    ap.add_argument("--factory-seed", type=int, default=-1)
    ap.add_argument("--factory-cache", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--val-n", type=int, default=0)
    ap.add_argument("--augment", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--feature-cache", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.synthetic = 0

    import numpy as np

    from multimodalspectraltransformer_torch import cli
    from multimodalspectraltransformer_torch.data.pipeline import (FeaturizeOptions, Loader,
                                                                   augment_records)
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    mcfg = cli._model_cfg(args)
    records = cli._load_records(args, dev)
    print(f"loaded {len(records)} records", flush=True)
    n_val = max(1, int(len(records) * 0.1))
    if args.val_n:
        n_val = min(n_val, args.val_n)
    train_records = records[:-n_val]
    n_train = len(train_records)
    opts = FeaturizeOptions(blank_percentage=0.0, randomize_smiles=False,
                            use_given_smiles_form=args.augment > 1)
    if args.augment > 1:
        train_records = augment_records(train_records, args.augment, seed=args.seed)
        print(f"augmented {n_train} -> {len(train_records)} records", flush=True)
    loader = Loader(train_records, mcfg, batch_size=max(1, min(args.batch_size, len(train_records))),
                    seed=args.seed, opts=opts)
    t0 = time.time()
    with cli._feature_cache(args.feature_cache):
        out = loader._featurize_all(max_bytes=1 << 62)
    if out is None:
        print("featurization fell back (stochastic?): nothing cached", flush=True)
        return 1
    big, kept = out
    nbytes = sum(np.asarray(x).nbytes for x in (*big.inputs, big.trg_tokens, big.trg_fp))
    print(f"featurized {len(kept)} rows, {nbytes / (1 << 30):.2f} GiB compact, "
          f"{time.time() - t0:.0f}s; cache dir {args.feature_cache}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
