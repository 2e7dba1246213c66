#!/usr/bin/env python3
"""Regenerate the pinned held-out evaluation bundle as reference-format CSVs.

The port's counterpart of ``scripts/regen_heldout_csv.py``: simulates the
molecules of a ``heldout_smiles.json`` (its ``smiles`` list, or a bare list)
through the data factory on the card and writes the ``export_reference_csvs``
bundle (``data_{1H,13C,HSQC,COSY}_0.csv`` and ``IR_data/``) as a ``.tar.gz``
under the top directory ``heldout_csv``, the form
``scripts/torch_accuracy_report.py --records-cache`` reads. Runs on the card
unless ``--device cpu``.

    python3 scripts/torch_regen_heldout_csv.py --smiles runs/accuracy_r2b/heldout_smiles.json \\
        --out chiprun_out/heldout_csv.tar.gz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smiles", required=True, help="heldout_smiles.json")
    ap.add_argument("--out", required=True, help=".tar.gz path")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    with open(args.smiles) as f:
        meta = json.load(f)
    smiles = meta["smiles"] if isinstance(meta, dict) else meta
    print(f"simulating {len(smiles)} held-out molecules...", flush=True)
    t0 = time.time()
    records = factory.simulate_records(smiles, device=dev)
    print(f"{len(records)} records in {time.time() - t0:.0f}s", flush=True)

    tmp_dir = args.out + ".dir"
    factory.export_reference_csvs(records, tmp_dir)
    tmp = args.out + ".tmp"
    with tarfile.open(tmp, "w:gz") as tf:
        tf.add(tmp_dir, arcname="heldout_csv")
    os.replace(tmp, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
