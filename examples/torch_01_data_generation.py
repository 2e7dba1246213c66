#!/usr/bin/env python3
"""Automatic NMR/IR data generation walkthrough, on the card.

The port's counterpart of ``examples/01_data_generation.py``: SMILES ->
predicted shifts (the trained GNNs on the device) -> 1H/13C/HSQC/COSY peak
lists and IR -> reference-format CSVs and SVG plots of the first molecule.
Runs on the card unless ``main(..., device="cpu")``.

Run: python3 examples/torch_01_data_generation.py [outdir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.serve import plots  # noqa: E402
from multimodalspectraltransformer_torch.sim import factory  # noqa: E402
from multimodalspectraltransformer_torch.utils.device import resolve_device  # noqa: E402

SMILES = [
    "CC(C)Cc1ccc(C(C)C(=O)O)cc1",  # ibuprofen
    "CC(=O)Nc1ccc(O)cc1",          # paracetamol
    "O=C(O)c1ccccc1OC(C)=O",       # aspirin
    "c1ccc2c(c1)cccc2",            # naphthalene
]


def main(out_dir: str = "data_gen_out", device=None) -> list:
    """Simulate, export and plot; returns the simulated records."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)

    # 1) simulate: filters, shift prediction, spectrum reconstruction
    records = factory.simulate_records(SMILES, device=dev)
    print(f"simulated {len(records)}/{len(SMILES)} molecules")

    # 2) export the reference CSV layout (sample-id, SMILES, shifts)
    paths = factory.export_reference_csvs(records, out_dir, run_id="demo")
    for modality, path in paths.items():
        print(f"  {modality}: {path}")

    # 3) plot each modality of the first molecule as standalone SVG
    rec = records[0]
    for modality in ("1H", "13C", "HSQC", "COSY"):
        svg = plots.plot_record(rec, modality)
        if svg:
            path = os.path.join(out_dir, f"{modality}.svg")
            with open(path, "w") as f:
                f.write(svg)
            print(f"  plot: {path}")
    return records


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "data_gen_out")
