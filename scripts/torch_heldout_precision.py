"""How many pinned held-out targets give back their query spectra exactly,
with the simulator's GNNs in float32 and in bfloat16.

Usage (on a CUDA card):
    python scripts/torch_heldout_precision.py \
        --records-cache runs/accuracy_r2b/heldout_csv.tar.gz \
        --heldout-dir runs/accuracy_r3 [--n 982]

The pinned held-out records (their HSQC and COSY, simulated in float32 on a
CPU) are the queries of the accuracy report. Each target SMILES is simulated
again with the port's factory (``sim.factory.simulate_records``: the GNNs
on the card, the reconstruction on the host), once in float32 (TF32 off)
and once with the GNNs under ``torch.autocast(dtype=torch.bfloat16)``, the
precision of default-precision matrix products on a TPU. A target counts as
reproduced when its HSQC and COSY assignment errors against its query are
both exactly 0 (``rank/matching.py``, as the harness scores candidates).
Prints one JSON line: the counts, the records, the seconds and the card.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def zero_error_count(records, dev, bf16: bool) -> tuple[int, int]:
    """(targets whose simulated HSQC and COSY equal the query's up to an
    assignment error of exactly 0, targets simulated)."""
    import torch

    from multimodalspectraltransformer_torch.rank import matching
    from multimodalspectraltransformer_torch.sim import factory

    ctx = torch.autocast(dev.type, dtype=torch.bfloat16) if bf16 else contextlib.nullcontext()
    with ctx:
        sims = factory.simulate_records([r.smiles for r in records],
                                        sample_ids=[r.sample_id for r in records], device=dev)
    by_id = {s.sample_id: s for s in sims}
    pairs = [(r, by_id[r.sample_id]) for r in records if r.sample_id in by_id]
    errs = {}
    for mod in ("hsqc", "cosy"):
        sel = [(q, c) for q, c in pairs if getattr(q, mod) and getattr(c, mod)]
        e = matching.batched_pairwise_assignment_error(
            [np.asarray(getattr(q, mod), float) for q, _ in sel],
            [np.asarray(getattr(c, mod), float) for _, c in sel], device=dev)
        errs[mod] = {q.sample_id: float(x) for (q, _), x in zip(sel, e)}
    n_zero = sum(errs["hsqc"].get(q.sample_id) == 0.0 and errs["cosy"].get(q.sample_id) == 0.0
                 for q, _ in pairs)
    return n_zero, len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--records-cache", default=os.path.join("runs", "accuracy_r2b",
                                                            "heldout_csv.tar.gz"))
    ap.add_argument("--heldout-dir", default=os.path.join("runs", "accuracy_r3"),
                    help="holds the pinned held-out list heldout_smiles.json")
    ap.add_argument("--n", type=int, default=982)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from torch_accuracy_report import device_line, load_heldout, load_records

    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = device_line(dev)
    heldout = load_heldout(args.heldout_dir, args.n)
    with tempfile.TemporaryDirectory() as scratch:
        records = load_records(args.records_cache, scratch)
    keep = set(heldout)
    records = [r for r in records if r.smiles in keep][: args.n]
    out = {"n_records": len(records), "device": card}
    for name, bf16 in (("float32", False), ("bfloat16", True)):
        t0 = time.perf_counter()
        n_zero, n_sim = zero_error_count(records, dev, bf16)
        out[name] = {"target_zero_error": n_zero, "simulated": n_sim,
                     "seconds": round(time.perf_counter() - t0, 3)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
