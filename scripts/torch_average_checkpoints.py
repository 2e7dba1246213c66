#!/usr/bin/env python3
"""Tail-average the parameters of the last K training snapshots of the port.

The port's counterpart of ``scripts/average_checkpoints.py`` (which made
``weights/mmt_r4_phase3_avg.msgpack.gz``): reads the snapshots that
``train/checkpoint.py::CheckpointManager`` wrote under ``--ckpt-dir`` (the
last ``--last`` of them, or ``--steps``), sums each parameter in float64 on
the device, divides by their count, casts back to the parameter's dtype and
exports the mean as a flax msgpack file (``.gz`` gzips it) that both
packages' ``import_params_msgpack`` read. Runs on the card unless
``--device cpu``.

    python3 scripts/torch_average_checkpoints.py --ckpt-dir run1/ckpt \\
        --out run1/params_avg.msgpack [--last 3] [--steps 40000 42500 45000]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def average_snapshots(ckpt_dir: str, steps=None, last: int = 3, device=None) -> tuple:
    """(the mean state dict on the CPU, the steps averaged) of the snapshots
    in ``ckpt_dir``; the mean of ``steps`` if given, else of the last
    ``last``. Raises FileNotFoundError when there is none or a step is
    missing."""
    import torch

    from multimodalspectraltransformer_torch.train.checkpoint import CheckpointManager
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mgr = CheckpointManager(ckpt_dir)
    steps = list(steps) if steps else mgr.steps()[-last:]
    if not steps:
        raise FileNotFoundError(f"no checkpoints found in {ckpt_dir}")
    acc, dtypes = None, None
    for s in steps:
        params = mgr.restore_params(s)
        if params is None:
            raise FileNotFoundError(f"step {s} missing in {ckpt_dir}")
        if acc is None:
            dtypes = {k: v.dtype for k, v in params.items()}
            acc = {k: v.to(dev, torch.float64) for k, v in params.items()}
        else:
            for k, v in params.items():
                acc[k] += v.to(dev, torch.float64)
    n = float(len(steps))
    return {k: (a / n).to(dtypes[k]).cpu() for k, a in acc.items()}, steps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--last", type=int, default=3)
    p.add_argument("--steps", type=int, nargs="*", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from multimodalspectraltransformer_torch.train import checkpoint as ckpt

    try:
        avg, steps = average_snapshots(args.ckpt_dir, args.steps, args.last, args.device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"averaging steps {steps}")
    ckpt.export_params_msgpack(avg, args.out)
    print(f"wrote {args.out} (mean of {len(steps)} checkpoints)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
