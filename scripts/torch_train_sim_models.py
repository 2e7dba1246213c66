"""Distill the rule teachers into the factory GNNs with the PyTorch port.

Usage (on a CUDA card; ``--device cpu`` runs it on the host):
    python scripts/torch_train_sim_models.py [--corpus 20000] [--shift-steps 6000] \
        [--ir-steps 4000] [--out runs/torch_sim_weights]

The port's counterpart of ``scripts/train_sim_models.py``, with the same
flags and defaults: it trains ``sim.gnn.NMRShiftModel`` on ``sim.shift_rules``
targets and ``sim.gnn.IRModel`` on ``sim.ir_rules`` targets over a generated
drug-like corpus (``data.molrandom``) and writes ``nmr_shift.msgpack``/``.json``
and ``ir.msgpack``/``.json`` into ``--out`` (the git-ignored
``runs/torch_sim_weights/`` by default; never the committed weights). Both
packages' ``load_*_weights`` read the files. Prints one JSON line per model,
its report with the corpus size, the wall seconds and the card's name and
power limit.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--gnn-steps", type=int, default=4)
    ap.add_argument("--shift-steps", type=int, default=6000)
    ap.add_argument("--ir-steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--skip-ir", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "torch_sim_weights"),
                    help="directory for the weight files (default: runs/torch_sim_weights)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from torch_accuracy_report import device_line

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import distill
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = device_line(dev)
    print(f"device: {card}", flush=True)

    t0 = time.time()
    corpus = molrandom.random_corpus(args.corpus, seed=args.seed)
    print(f"corpus: {len(corpus)} molecules in {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    data = distill.build_teacher_dataset(corpus, with_ir=not args.skip_ir)
    print(f"teacher dataset: {len(data['n_atoms'])} graphs in {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    model, stats, report = distill.train_shift_model(
        data, hidden=args.hidden, steps=args.gnn_steps, batch_size=args.batch,
        n_steps=args.shift_steps, seed=args.seed, device=dev)
    report["corpus_size"] = len(corpus)
    report["wall_s"] = round(time.time() - t0, 1)
    distill.save_shift_weights(model, stats, report, args.out)
    print("shift model:", json.dumps({**report, "device": card}), flush=True)

    if not args.skip_ir:
        t0 = time.time()
        ir_model, ir_report = distill.train_ir_model(
            data, hidden=args.hidden, steps=args.gnn_steps, batch_size=max(64, args.batch // 2),
            n_steps=args.ir_steps, seed=args.seed, device=dev)
        ir_report["corpus_size"] = len(corpus)
        ir_report["wall_s"] = round(time.time() - t0, 1)
        distill.save_ir_weights(ir_model, ir_report, args.out)
        print("ir model:", json.dumps({**ir_report, "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
