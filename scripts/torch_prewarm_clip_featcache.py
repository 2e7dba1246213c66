#!/usr/bin/env python3
"""Pre-warm the featurized-dataset cache (``MMT_FEATURE_CACHE``) of the
port's ``cli train-clip``.

The port's counterpart of ``scripts/prewarm_clip_featcache.py``. The
contrastive trainer holds out the first ``--eval-n`` records and drops the
SMILES that would truncate under the target framing, so its features digest
differs from ``cli train``'s and ``scripts/torch_prewarm_featcache.py``'s
entry never hits. This script builds its loader the same way (the records of
``--factory N`` from ``--factory-cache``, or simulated on the device and
written there; the split; ``_drop_truncating_records``; the weight-sorted
loader) and writes ``DIR/mmt_features_<digest>.npz``, which ``cli
train-clip --feature-cache DIR`` (or a ``<factory-cache>.featcache`` sidecar
naming DIR) then reads. Runs on the card unless ``--device cpu``.

    python3 scripts/torch_prewarm_clip_featcache.py --factory 291006 --factory-seed 3133 \\
        --factory-cache factory_r3_300k.pkl --eval-n 256 --feature-cache featcache_r3
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
    ap.add_argument("--eval-n", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--feature-cache", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.synthetic = 0

    from multimodalspectraltransformer_torch import cli
    from multimodalspectraltransformer_torch.data.pipeline import Loader
    from multimodalspectraltransformer_torch.train.contrastive import (ContrastiveConfig,
                                                                       _drop_truncating_records)
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    mcfg = cli._model_cfg(args)
    records = cli._load_records(args, dev)
    print(f"loaded {len(records)} records", flush=True)
    if args.eval_n > 0:
        records = records[args.eval_n :]
    records = _drop_truncating_records(records, mcfg)
    loader = Loader(records, mcfg, args.batch_size, seed=args.seed,
                    order_strategy=ContrastiveConfig.order_strategy)
    print(f"digest {loader.features_digest()}; featurizing...", flush=True)
    t0 = time.time()
    with cli._feature_cache(args.feature_cache):
        out = loader._featurize_all(max_bytes=1 << 62)
    print(f"done in {time.time() - t0:.0f}s; "
          f"{'cached' if out is not None else 'FELL BACK (see the reason above)'}", flush=True)
    return 0 if out is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
