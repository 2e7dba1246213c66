"""Whether ``run_training`` gives the same parameters run after run on the card.

    python3 scripts/torch_train_determinism.py [--reps 6] [--det-reps 4] [--out FILE]

The check behind ``chip_smoke.py`` phase 10 (a), repeated: phase3 trained
for 5 bf16 steps at batch 64 on the records of the smoke's training phase
(``random_corpus(256, seed=3133)`` simulated on the card, augmented 2x),
alternately without a mesh and with a one-rank NCCL ``make_mesh()``, ``--reps``
times each with PyTorch's default algorithms and then ``--det-reps`` times
each under ``torch.use_deterministic_algorithms(True)``. Every run is held bit
for bit against the first; for a run that differs it names the step and the
tensors whose gradients differed first, and the tensors that differ at the
end. The runs go to ``--out`` as JSON; the last line is a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
STEPS, BATCH = 5, 64
sys.path.insert(0, REPO)


def _gradient_signatures(model) -> tuple[list, "object"]:
    """The names of the parameters with a gradient and, per gradient, the sum
    of its float32 bit patterns (equal bits give equal sums)."""
    import torch

    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    sigs = [g.detach().float().contiguous().view(torch.int32).long().sum() for _, g in named]
    return [n for n, _ in named], torch.stack(sigs).cpu()


def rank_runs(records, reps: int, det_reps: int) -> list:
    """In the one rank of an NCCL world: the runs, each held against the first."""
    import torch

    from multimodalspectraltransformer_torch import parallel
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import convert
    from multimodalspectraltransformer_torch.train import loop
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = MMTConfig(model=ModelConfig(), train=TrainConfig(learning_rate=3e-5, mixed_precision=True))
    init = convert.from_jax_params(convert.read_msgpack(PHASE3))
    opts = dp.FeaturizeOptions(use_given_smiles_form=True)
    mesh = parallel.make_mesh()
    plain_step, trace = loop.train_step, []

    def traced_step(*args, **kwargs):
        state, m = plain_step(*args, **kwargs)
        trace.append(_gradient_signatures(state.model))
        return state, m

    loop.train_step = traced_step
    ref, rows = None, []
    for det, n in ((False, reps), (True, det_reps)):
        torch.use_deterministic_algorithms(det)
        for i in range(n):
            for name, m in (("plain", None), ("mesh", mesh)):
                trace.clear()
                loader = dp.Loader(records, cfg.model, batch_size=BATCH, opts=opts)
                t0 = time.perf_counter()
                res = loop.run_training(cfg, loader, init_params=init, mesh=m, max_steps=STEPS,
                                        device=dev)
                secs = time.perf_counter() - t0
                losses = [h["train_loss"] for h in res.metrics.history]
                params = {k: v.cpu() for k, v in res.state.model.state_dict().items()}
                if ref is None:
                    ref = (losses, params, list(trace))
                differ = {k: float((v.double() - ref[1][k].double()).abs().max())
                          for k, v in params.items() if not torch.equal(v, ref[1][k])}
                first = None  # (step, tensors) where the gradients first differ
                for step, ((names, g), (_, rg)) in enumerate(zip(trace, ref[2])):
                    if not torch.equal(g, rg):
                        first = (step, [t for t, a, b in zip(names, g.tolist(), rg.tolist()) if a != b])
                        break
                rows.append(dict(deterministic=det, rep=i, run=name, secs=secs,
                                 losses_equal=losses == ref[0], tensors_differ=differ,
                                 first_gradient_difference=first))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--det-reps", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "train_determinism.json"))
    args = ap.parse_args(argv)

    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(None)  # the card; raises without one
    import torch

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.parallel.launch import launch
    from multimodalspectraltransformer_torch.sim import factory

    smiles = molrandom.random_corpus(256, seed=3133)
    recs = factory.simulate_records(smiles, sample_ids=[f"f{i}" for i in range(len(smiles))],
                                    device=dev)
    n_val = max(1, int(len(recs) * 0.1))
    train_recs = dp.augment_records(recs[:-n_val], 2, seed=0)[: STEPS * BATCH]
    # cuBLAS is bitwise reproducible beside NCCL's streams only with a fixed
    # workspace, which deterministic algorithms also require
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # the rank imports this file
    rows = launch("torch_train_determinism:rank_runs", 1, args=(train_recs, args.reps, args.det_reps),
                  device=dev, backend="nccl", timeout=900)[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(torch=torch.__version__, card=torch.cuda.get_device_name(0), runs=rows), f,
                  indent=1)
    for r in rows:
        if r["tensors_differ"] or not r["losses_equal"]:
            print(f"differs: {'deterministic' if r['deterministic'] else 'default'} algorithms, "
                  f"{r['run']} run {r['rep']}: losses {'equal' if r['losses_equal'] else 'differ'}, "
                  f"first gradient difference {r['first_gradient_difference']}, at the end "
                  f"{r['tensors_differ']}")
    for det in (False, True):
        sel = [r for r in rows if r["deterministic"] == det]
        bad = sum(bool(r["tensors_differ"]) or not r["losses_equal"] for r in sel)
        print(f"{'deterministic' if det else 'default'} algorithms: {bad} of {len(sel)} runs differ "
              f"from the first; {sum(r['secs'] for r in sel) / max(1, len(sel)):.2f} s a run of "
              f"{STEPS} steps; {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
