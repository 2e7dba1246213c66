#!/usr/bin/env python3
"""Export a training run's newest parameters as a bf16 msgpack checkpoint.

The port's counterpart of ``scripts/export_latest.py``: a run cut off by its
wall clock never writes ``<run>/params.msgpack``, but its ``--save-every``
snapshots live in ``<run>/ckpt``. This takes ``params.msgpack`` when it is
there, else the newest snapshot, and writes it with every leaf cast to bfloat16
as the flax msgpack file (``.gz`` gzips it) that both packages'
``import_params_msgpack`` read. The work is a host copy; like every entry
point of the port it resolves ``--device`` (cuda by default) first and
raises without CUDA unless ``--device cpu``.

    python3 scripts/torch_export_latest.py RUN_DIR OUT.msgpack.gz
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir")
    p.add_argument("out")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from multimodalspectraltransformer_torch.train import checkpoint as ckpt
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    resolve_device(args.device)  # raises without CUDA unless --device cpu
    final = os.path.join(args.run_dir, "params.msgpack")
    if os.path.exists(final):
        params, step = ckpt.import_params_msgpack(final), "final"
    else:
        ckpt_dir = os.path.join(args.run_dir, "ckpt")
        if not os.path.isdir(ckpt_dir):
            print(f"no params.msgpack and no {ckpt_dir}", file=sys.stderr)
            return 1
        manager = ckpt.CheckpointManager(ckpt_dir)
        step = manager.latest_step()
        params = manager.restore_params(step) if step is not None else None
        if params is None:
            print(f"no restorable step in {ckpt_dir}", file=sys.stderr)
            return 1
    ckpt.export_params_msgpack(params, args.out, dtype=torch.bfloat16)
    print(f"exported {args.out} (step {step})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
