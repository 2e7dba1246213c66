#!/usr/bin/env python3
"""Where the time goes on the GPU: the port's evaluate_molecules, its beam
mode or its train step, timed and traced.

    python3 scripts/torch_profile_main_path.py [--mols 8 48] [--out runs/torch_profile]
    python3 scripts/torch_profile_main_path.py --beam [--out runs/torch_profile]
    python3 scripts/torch_profile_main_path.py --train [--out runs/torch_profile]

Without ``--beam``, for each molecule count: records from
``simulate_records(random_corpus(2n, seed=123)[:n])``, the committed phase3
weights at the full width of ``ModelConfig()``, ``DecodeConfig(max_len=64,
fanout=128, multinom_runs=10, max_temp_rounds=5, compute_dtype="bfloat16")``,
CLIP scoring with the committed clip_r4 tower and ``clip_block`` 10 (the
configuration of chip_smoke.py and of bench.py's e2e mode; 48 is bench.py's
molecule count). One warm-up run, two timed runs (host clock, each ending in a device
sync). The Chrome trace of the first count goes to
``<out>/torch_trace_<n>.json.gz``.

With ``--beam``: beam mode (``multimodalspectraltransformer_torch/eval/
beam_bench.py``, the counterpart of bench.py's ``BENCH_MODE=beam``): 128
molecules with seeded uniform spectra, beam 5, 128 steps without early exit,
bf16. One warm-up call and three timed calls (host clock, each ending when
the tokens reach the host).

With ``--train``: the train step of ``chip_smoke.py``'s training phase (full
width from phase3, batch 64 from its device-resident dataset, lr 3e-5), in
bf16 mixed precision and in fp32: five warm-up steps, then three steps.

Then one run under torch.profiler (three steps with ``--train``): device
busy time (the union of kernel intervals) over the run's wall time, CUDA
kernels launched, and the kernels by device time. Prints one JSON line per
run and writes ``<out>/torch_profile_main_path.json``
(``torch_profile_beam.json`` with ``--beam``, ``torch_profile_train.json``
with ``--train``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASE3 = "weights/mmt_r4_phase3.msgpack.gz"
CLIP_R4 = "weights/clip_r4.msgpack.gz"


def _union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _profile(fn):
    """Run ``fn`` once under torch.profiler; return the device summary and
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events, without the ranges of user annotations such as the
    # optimizer's step, which span kernels counted on their own
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    row = dict(profiled_wall_s=wall_us / 1e6, device_busy_s=busy_us / 1e6,
               device_idle_share=1 - busy_us / wall_us, cuda_kernels=len(kernels),
               top_kernels=[dict(name=k[:90], calls=c, device_ms=t / 1e3) for k, (c, t) in top])
    return row, prof


def _emit(report: dict, row: dict) -> None:
    print(json.dumps(row), flush=True)
    report["runs"].append(row)


def profile_main_path(model, dev, mols: list, out: str, report: dict) -> None:
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.ops import auction, decode_attention
    from multimodalspectraltransformer_torch.rank import clip
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig

    dcfg = DecodeConfig(max_len=64, fanout=128, multinom_runs=10, max_temp_rounds=5,
                        compute_dtype="bfloat16")
    run = dict(clip_bundle=clip.load_bundle(CLIP_R4, device=dev), clip_block=dcfg.multinom_runs,
               device=dev)
    for n in mols:
        records = factory.simulate_records(molrandom.random_corpus(2 * n, seed=123)[:n], device=dev)
        harness.evaluate_molecules(records, model, dcfg, seed=1, **run)  # warm-up
        for rep in range(2):
            decode_attention.reset_launches()
            auction.reset_launches()
            t0 = time.perf_counter()
            _res, summary = harness.evaluate_molecules(records, model, dcfg, seed=rep, **run)
            _emit(report, dict(mols=len(records), rep=rep, wall_s=time.perf_counter() - t0,
                               mols_per_s=summary.mols_per_sec, top1=summary.top_k_accuracy[1],
                               top5=summary.top_k_accuracy[5], stage_s=summary.stage_seconds,
                               k1_launches=decode_attention.launches, k2_launches=auction.launches))
        row, prof = _profile(lambda: harness.evaluate_molecules(records, model, dcfg, seed=0, **run))
        _emit(report, dict(mols=len(records), **row))
        if n == mols[0]:  # one trace, gzipped: the larger ones run to tens of MB
            path = os.path.join(out, f"torch_trace_{len(records)}.json")
            prof.export_chrome_trace(path)
            subprocess.run(["gzip", "-f", path], check=True, timeout=300)


def profile_beam_mode(model, dev, report: dict, reps: int = 3) -> None:
    from multimodalspectraltransformer_torch.eval import beam_bench
    from multimodalspectraltransformer_torch.ops import beam_attention

    batch = beam_bench.beam_mode_batch(model.cfg, device=dev)
    warm, _ = beam_bench.run(model, batch)
    report["runs"].append(dict(warmup_s=warm["total"]))
    for rep in range(reps):
        beam_attention.reset_launches()
        stages, _ = beam_bench.run(model, batch)
        _emit(report, dict(rep=rep, wall_s=stages["total"],
                           mols_per_s=beam_bench.BATCH / stages["total"], stage_s=stages,
                           k3_launches=beam_attention.launches))
    row, _prof = _profile(lambda: beam_bench.run(model, batch))
    _emit(report, row)


def profile_train(dev, report: dict, steps: int = 3) -> None:
    import chip_smoke

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig

    mcfg = ModelConfig()
    loader, _val, init = chip_smoke.train_data(dev, mcfg)
    dd = loader.device_dataset(dev)
    rows = list(loader.epoch_row_batches(0)) + list(loader.epoch_row_batches(1))
    for name, mixed in (("bf16", True), ("fp32", False)):
        cfg = MMTConfig(model=mcfg, train=TrainConfig(learning_rate=3e-5, mixed_precision=mixed))
        model = mmt.MultimodalTransformer(mcfg)
        model.load_state_dict(init)
        state = st.create_state(cfg.train, model.to(dev))
        for idx in rows[:5]:
            step.train_step(cfg, state, dp.gather_rows(dd, idx))

        def run():
            for idx in rows[5 : 5 + steps]:
                step.train_step(cfg, state, dp.gather_rows(dd, idx))

        row, _prof = _profile(run)
        _emit(report, dict(train=name, steps=steps, batch=loader.batch_size,
                           cuda_kernels_per_step=row["cuda_kernels"] / steps, **row))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mols", type=int, nargs="+", default=[8, 48])
    ap.add_argument("--beam", action="store_true", help="profile beam mode instead")
    ap.add_argument("--train", action="store_true", help="profile the train step instead")
    ap.add_argument("--out", default="runs/torch_profile")
    args = ap.parse_args()

    import torch

    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.utils.config import ModelConfig

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {card}; torch {torch.__version__}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    report = {"card": card, "runs": []}
    if args.train:
        profile_train(dev, report)
        name = "torch_profile_train.json"
    else:
        model = mmt.load_model(PHASE3, ModelConfig(), device=dev)
        if args.beam:
            profile_beam_mode(model, dev, report)
        else:
            profile_main_path(model, dev, args.mols, args.out, report)
        name = "torch_profile_beam.json" if args.beam else "torch_profile_main_path.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
