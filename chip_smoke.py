#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or a few):

1. build   - compiles the CUDA kernels (``csrc/*.cu``, one plain nvcc call)
             and the host chemistry library (g++), printing seconds and paths;
2. kernels - K1 (decode attention), K2 (auction) and K3 (beam attention) on
             the card at their paths' shapes, each held against its plain
             PyTorch version (K2 also against scipy), with times; E1 (the
             fixed-order gradient of the trained lookup tables) at the
             tables' training shapes against its plain version in float64
             and against itself run twice, with times beside
             ``aten.embedding_dense_backward``'s;
3. main    - ``evaluate_molecules`` as bench.py's e2e mode runs it: the full
             width of ``ModelConfig()`` with the committed phase3 weights on 8
             simulated molecules, fan-out 128, bf16 decoding, CLIP scoring
             with the committed clip_r4 tower (``clip_block`` 10); the
             kernels' launch counters are set to 0 just before the run and
             read just after; the CLIP stage's seconds, tokens, FLOPs and
             share of the card's float32 peak;
4. check   - the run's outputs: finite CLIP scores on every candidate, every
             scored pair against scipy's optimum, the greedy decode on the
             card (K1) against the CPU's plain path at float32, token for
             token, and ``score_candidates_batch`` on the card against the CPU
             on the run's candidates, in float32 and bfloat16;
5. beam    - (a) beam mode (bench.py's ``BENCH_MODE=beam``): 128 molecules
             with seeded uniform spectra, beam 5, 128 steps without early
             exit, bf16, one warm-up and two timed calls with the counters
             reset before each (K3: 768 launches a call); (b) at float32 on 8
             of those molecules, ``beam_search`` (K3) on the card against
             ``beam_search_materialized`` (K1) on the card and against the
             CPU's plain path, token for token; (c) ``evaluate_molecules`` on
             the 8 molecules of phase 3 with the beam and greedy hypotheses
             in the pools, every gated beam and greedy hypothesis checked to
             be there;
6. train   - the trainer at the full width of ``ModelConfig()`` from phase3,
             its lookup tables' gradients through E1 (the JAX training path
             reaches no Pallas kernel): 256 factory molecules simulated on the card, the
             training 90% augmented 2x with SMILES variants, batch 64, the
             device-resident dataset. Median step time after 5 warm-up steps,
             samples/s, target tokens/s and peak memory in bf16 mixed
             precision and in fp32; FLOPs per step (FlopCounterMode) and
             TFLOP/s; ``run_training`` for 40 bf16 steps at lr 3e-5 with
             validation, the per-epoch plateau and checkpoints, first and last
             loss, and every 10 steps the in-training generation metrics with
             every auxiliary term live (greedy decodes through K1, whose
             launches are counted, as E1's are: 3 a step; spectral feedback
             simulated on the card).
             Checks: one fp32 step (dropout and TF32 off) on the card
             against the CPU; 30 fp32 steps from the port's own init halve the
             loss on one batch of 8; a checkpoint resumed at step 3 continues
             as the uninterrupted run (dropout on); the bf16 msgpack export
             reads back as the parameters rounded to bf16; every loss finite;
             ``generation_metrics`` on 8 records in fp32 on the card against
             the CPU (the same generations, the metrics within 1e-6);
7. serve   - the serving console (``serve/app.py``) at full width in a
             threaded server on 127.0.0.1: phase3 loaded by a job; the main
             path's 8 molecules simulated; the records, plot and SVG routes;
             the evaluate route (the main path's decoding, simulated errors)
             read through its SSE stream, its greedy SMILES and
             corr_sampling_prob held to a direct ``evaluate_molecules`` call;
             an evaluate with beam 5 (K3); run_exp_data on 5 of the records
             written in the AZ format, through the real-data blend; one
             improvement cycle (5 steps), after which the server serves the
             fine-tuned model; two jobs in turn and a pending one cancelled.
             Milliseconds from each POST to its answer, each job's seconds,
             mols/s through the server against the direct call, the cycle's
             stages, and the launches of K1-K3 by the server's jobs;
8. contrastive - the CLIP trainer at clip_r4's width (6 layers, 768 wide)
             from clip_r4 over the frozen phase3 MMT with r4's recipe (batch
             256, lr 1e-4, weight decay 1e-3, weight_sorted, dropout 0.1, 64
             text tokens) on phase 6's factory records plus 384 more, the
             first 64 held out: ``train_contrastive`` for 6 steps, retrieval
             R@1/R@5 before and after on those 64 and on the accuracy
             report's 982 pinned held-out records, the median step time,
             samples/s, FLOPs (FlopCounterMode), TFLOP/s and peak memory;
             checks: a tower step (dropout off) from clip_r4 on the card
             against the CPU, on the first batch of 64 pinned held-out
             records whose loss is at least 1e-2, resume
             from the ``.state`` snapshot bit-exact, the bundle that
             ``save_bundle`` wrote scoring the main path's candidates through
             ``evaluate_molecules``. Then the BLIP trainer at
             ``QFormerConfig()`` width, batch 32: step time, peak memory,
             finite losses, and ``lm_generate_greedy`` on 8 molecules, card
             against CPU, token for token. No kernel of its own: the JAX
             towers reach no Pallas kernel;
9. tools   - the simulators' trainer at the committed width (hidden 128, 4
             message steps, 1801 IR bins) on the rule teachers' labels of
             ``random_corpus(4096, seed=11)``: the committed weights, one step
             at lr 0, report JAX's held-out MAEs; 3 steps of each trainer on
             the card against the CPU; 200 steps timed (ms a step, samples/s,
             TFLOP/s, peak memory, CUDA kernels a step); the weight files
             written and read back, the committed ones unchanged (sha256).
             The vector DB: phase3's fingerprints of phase 6's records on
             the card against the CPU, self-retrieval and top 10 by cosine;
             a Morgan DB of 10,000 molecules queried 256 times; UMAP and the
             HTML plot; ``cli vectorize`` in a subprocess; phase3 through a
             Lightning-style torch checkpoint decoding as phase3. No kernel:
             the JAX package computes all of it outside Pallas;
10. parallel - data and tensor parallelism (``parallel/``), each rank a
             process started by ``parallel/launch.py`` on this card, against
             one process on it: (a) one rank over NCCL, ``run_training`` for
             5 bf16 steps from phase3 with ``make_mesh()`` and without, bit
             for bit, both under deterministic algorithms; (b) two ranks over gloo as (data 2), one fp32 step
             (TF32 off, dropout on) at full width from phase3, batch 64:
             loss within 2e-5 relative, gradients within 5e-5 of each leaf's
             largest magnitude, the updated parameters within 5e-5 of theirs
             where the gradient is resolved; (c) the same step as (data 1,
             model 2), 8 heads and half the feed-forward a rank, computed in
             float64 on both sides (in fp32 the ranks' partial sums put some
             inputs within rounding of 0 on the other side of ReLU's kink),
             held to the same bounds; the median bf16 step of each
             arrangement and the gradient all-reduce's ms; the host
             loader's batches under stochastic featurization, each rank
             building only its rows, in ms against one process;
             (d) ``evaluate_molecules(mesh=...)`` on phase 3's 8 molecules
             with phase3 and clip_r4, fan-out 128, round-shrink off on both
             sides: at float32 greedy token-identical, every candidate set
             equal, ``corr_sampling_prob`` within 1e-4 relative; in bf16 the
             mols/s of the two ranks against one process and each rank's K1
             and K2 launches (counters reset just before); (e) the sharded
             device dataset: each rank's gathered batches are the rows of
             the port's copy of JAX's ``epoch_row_batches_sharded``. Two
             ranks time-slice one card: no figure here is a scaling figure;
11. drivers - the evaluation and data drivers at full width (phase3,
             clip_r4, bf16), their output under ``chiprun_out/drivers/``:
             (a) ``scripts/torch_accuracy_report.py`` from scratch (16
             held-out molecules of ``--mw-band 0,350`` disjoint from
             ``random_corpus(2000, seed=11)``, records simulated on the card
             and cached as a directory, chunks of 8, beam 5, greedy in pool,
             2 rounds), its K1/K2/K3 launches, stage seconds and mols/s a
             chunk; run again it resumes every chunk with no launch and the
             same numbers; from a fresh ``--out`` it reads the cache (the same
             records) and with ``--sim-weights`` at the committed shift
             weights gives the same report; (b) ``scripts/torch_eval_sweep.py``
             on those 16 molecules in chunks of 4 over two shards in turn,
             merged, against one shard; (c) ``scripts/torch_build_factory_cache.py``
             on 64 molecules, then ``cli train --factory 64 --factory-cache``
             for 2 bf16 steps with the simulator refused; (d) three
             ``run_training`` snapshots averaged by
             ``scripts/torch_average_checkpoints.py`` (held to numpy's float64
             mean, leaf for leaf) and the newest exported in bf16 by
             ``scripts/torch_export_latest.py``; (e) the four examples
             (``examples/torch_0*.py``) at the JAX examples' settings; the
             phase's seconds;
12. campaign - the reference-test-set adaptation scripts at full width
             (phase3, bf16 decoding), their output under
             ``chiprun_out/campaign/``: (a) a stand-in for the shipped test
             set (no measure of accuracy on the reference's data): two
             disjoint sets of 96 molecules of ``random_corpus(192,
             min_mw=250, max_mw=350)`` with ids in both halves of the split,
             simulated on the card by the committed shift weights scaled by
             1.1 and written in the shipped headerless CSV format, 13C/HSQC/
             COSY of the first set and 1H of the second; (b)
             ``scripts/torch_sgnn_adapt.py`` on it, 300 steps at batch 128:
             the assignment counts, ms a step, the eval half's metrics
             before and after (its 13C nearest-peak MAE must fall); (c) the
             corpus chain: ``torch_zinc_corpus`` (256 molecules seeded from
             the adapt half), ``torch_build_factory_cache`` on it,
             ``torch_r4_mem_control --dup 4``, ``torch_build_mixture_corpus``,
             ``torch_build_sgnn_corpus --n 256`` with (b)'s weights (its
             simulation rate), each pickle's count and ids checked, then
             ``cli train`` from the mixture for 2 bf16 steps with the
             simulator refused; (d) ``torch_control_adapted_sim_eval`` on 8
             adapt-half molecules with (b)'s weights, the K1 and K2 launches
             counted from 0, mols/s, every scored error finite; (e)
             ``torch_real_data_demo`` on 5 records of (a) in the AZ format
             (10 and 20 steps a fold, fan-out 16, 2 rounds): after each arm-1
             fold every tensor but ``real_data_linear`` bit-equal to phase3,
             after each arm-2 fold only ``decoder``, ``fc_out`` and
             ``real_data_linear`` moved, the K1 launches under the blend, the
             folds' seconds; (f) ``torch_chemotype_stats`` and
             ``torch_make_r3_corpus`` (slabs cut to 2000/500/500) on this
             machine; the committed simulator weights unchanged; the phase's
             seconds;
13. bench  - the headline bench and the utilization report, each in a
             process of its own, their output under ``chiprun_out/bench/``:
             ``python3 bench_torch.py`` at its defaults (e2e: 48 molecules,
             phase3, clip_r4) and with ``BENCH_MODE=beam`` (128 molecules x
             beam 5 x 128 steps), ``cli bench --batch 16`` in beam mode, and
             ``scripts/torch_roofline_report.py``. Each bench's stdout is
             exactly one JSON line with bench.py's keys, unit mols/sec/chip
             and ``value`` the molecules over the best rep it printed on
             stderr; every e2e rep launched K1 and K2, every beam call K3 768
             times (128 steps x 6 layers); the report's shares of the bf16 and
             HBM peaks lie in (0, 1.05]. The lines, reps, stage seconds,
             launches, peak memory and the phase's seconds;
14. repro  - reproducible training under PyTorch's default algorithms, by
             ``scripts/torch_train_determinism.py``'s runs in this process,
             each run held bit for bit against the first (losses and every
             parameter): ``run_training`` from phase3, 5 bf16 steps at batch
             64 on phase 6's records, 40 runs; the CLIP tower from clip_r4 at
             batch 256 and the BLIP tower at ``QFormerConfig()`` and batch
             32, 3 steps over the frozen phase3 encode, 10 runs each; the
             shift and IR trainers, 5 steps at batch 256 and 128, 10 runs
             each. E1's launches are counted from 0 for each trainer (3, 2,
             2, 0 and 0 a step). Then the script's ``--step-times`` in a
             process of its own: the median MMT, CLIP and BLIP steps with the
             former lookups, through E1, and with the former under the
             deterministic switch, in turn on the same batches. Its output
             under ``chiprun_out/determinism/``.

The simulator's GNN weights must load before anything runs: without them
the factory falls back to its rule teachers and every phase would score
other spectra.

The timed shapes and the timers come from ``kernel_timing.py``, which
``scripts/torch_kernel_times.py`` shares. Each timed kernel reports
``device_ms``, its cold device time (``kernel_timing.graph_ms``: one
CUDA-graph replay of launches over enough copies of the inputs to exceed the
L2, between CUDA events), beside ``ms``, the eager time per call (which
includes the host's enqueue), and its bound and ``bound_share`` from
``device_ms``. ``--save-hsqc PATH`` also saves the main path's HSQC cost.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises: the script exits non-zero and prints no result. It also fails
without a CUDA device, and without the rest of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import kernel_timing as kt

from multimodalspectraltransformer_torch.utils.roofline import H100_HBM_BYTES_PER_S, H100_PEAK_FLOPS

HBM_BYTES_PER_S = H100_HBM_BYTES_PER_S
F32_FLOPS = H100_PEAK_FLOPS["float32"]
BF16_FLOPS = H100_PEAK_FLOPS["bfloat16"]

K1_SOURCE = "multimodalspectraltransformer_torch/csrc/decode_attention.cu"
K1_REPLACES = "multimodalspectraltransformer_tpu/ops/decode_attention.py:49"
K2_SOURCE = "multimodalspectraltransformer_torch/csrc/auction.cu"
K2_REPLACES = "multimodalspectraltransformer_tpu/ops/auction.py:30"
K3_SOURCE = "multimodalspectraltransformer_torch/csrc/beam_attention.cu"
K3_REPLACES = "multimodalspectraltransformer_tpu/ops/beam_attention.py:34"
E1_SOURCE = "multimodalspectraltransformer_torch/csrc/embedding_grad.cu"
# no Pallas kernel: the gradient of the JAX package's target-token lookup
# (flax's nn.Embed), which XLA computes as a scatter-add
E1_REPLACES = "multimodalspectraltransformer_tpu/models/mmt.py:123"
PHASE3 = "weights/mmt_r4_phase3.msgpack.gz"
CLIP_R4 = "weights/clip_r4.msgpack.gz"
# the accuracy report's pinned held-out molecules and their records
HELDOUT_DIR = "runs/accuracy_r3"
HELDOUT_RECORDS = "runs/accuracy_r2b/heldout_csv.tar.gz"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_row(device_ms: float, t_bytes: float, t_ops: float) -> dict:
    """The bound (the larger of bytes over the memory rate and operations
    over the peak rate) and its share of ``device_ms``."""
    bound_ms = max(t_bytes, t_ops) * 1e3
    return dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_share=bound_ms / device_ms)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def measure_k1(q, kv, pos: int, rtol: float, label: str, timed: bool) -> dict:
    """Hold K1 against its plain version on (q, kv, pos); with ``timed``
    also time the kernel (cold device time and eager), the plain version and
    SDPA, and compute the bound."""
    import torch
    import torch.nn.functional as F

    from multimodalspectraltransformer_torch.ops import decode_attention as k1

    out = k1.decode_attention(q, kv, pos)
    ref = k1.decode_attention_plain(q, kv, pos)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = rtol * max(1.0, ref.float().abs().max().item())
    log(f"[kernels] K1 {label}: max_abs_err={err:.3e} tol={tol:.1e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version ({label})")
    if not timed:
        return {}
    B, H, Dh = q.shape
    live = pos + 1
    device_ms = kt.graph_ms(lambda q_, kv_: k1.decode_attention(q_, kv_, pos), (q, kv), 200)
    ms = kt.cuda_ms(lambda: k1.decode_attention(q, kv, pos), 200)
    plain_ms = kt.cuda_ms(lambda: k1.decode_attention_plain(q, kv, pos), 50)
    k_live = kv[:, :, :Dh, :live].transpose(-1, -2).contiguous()
    v_live = kv[:, :, Dh:, :live].transpose(-1, -2).contiguous()
    q4 = q[:, :, None, :]
    lib_ms = kt.cuda_ms(lambda: F.scaled_dot_product_attention(q4, k_live, v_live, scale=1.0),
                        50)
    nbytes = (2 * B * H * Dh + B * H * 2 * Dh * live) * q.element_size()
    flops = B * H * live * (4 * Dh + 4)  # q.k and p.v multiply-adds, max, exp, sum
    row = dict(max_abs_err=err, device_ms=device_ms, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **bound_row(device_ms, nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS))
    log(f"[kernels] K1 {label}: device {device_ms:.5f} ms cold ({row['bound_share']:.1%} of the "
        f"bound {row['bound_ms']:.5f} ms, {row['bound_by']}), eager {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms")
    return row


def check_k1(dev) -> dict:
    """K1 at the decode step's shapes: H=16, Dh=8, T=cfg.max_len=128, lanes
    1024 (8 molecules x fan-out 128, this script's main path) and 6144
    (48 x 128), several positions, and the other head sizes the kernel takes
    (16, 32, 64) at 256 lanes and 8 heads: fp32 (1e-5 relative) and bf16
    (2^-7). Then the timed shapes of ``kernel_timing.k1_cases``. Returns the
    row of the main path's shape (1024 lanes, bf16, pos 63)."""
    import torch

    T = 128
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, Dh in ((1024, 16, 8), (6144, 16, 8), (256, 8, 16), (256, 8, 32), (256, 8, 64)):
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
            q = (torch.randn(B, H, Dh, generator=gen, device=dev) / Dh**0.5).to(dtype)
            kv = torch.randn(B, H, 2 * Dh, T, generator=gen, device=dev).to(dtype)
            for pos in (0, 17, 63, 127):
                measure_k1(q, kv, pos, rtol, f"B={B} H={H} Dh={Dh} {str(dtype)[6:]} pos={pos}",
                           timed=False)
    rows = {label: measure_k1(q, kv, pos, 1e-5 if q.dtype == torch.float32 else 2.0**-7, label,
                              timed=True)
            for label, q, kv, pos in kt.k1_cases(dev)}
    return rows["B=1024 H=16 Dh=8 bfloat16 pos=63"]


def measure_k2(cost, label: str, timed: bool, pallas_cap: bool = True) -> dict:
    """Hold K2 against its plain version (1e-4 absolute; both sum the total
    in float64), with the same rounds per problem, and against scipy's
    optimum (the auction's N * eps_last guarantee plus 1e-4); with
    ``pallas_cap`` also log how the Pallas round cap would fare; with
    ``timed`` also time kernel and plain version and compute the bound."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from multimodalspectraltransformer_torch.ops import auction as k2

    B, N, _ = cost.shape
    out, k_rounds = k2.auction_assignment_cost(cost, return_iters=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, rounds = k2.auction_assignment_cost_plain(cost, return_iters=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3  # one call: it takes seconds at the larger N
    err = (out - ref).abs().max().item()
    same_rounds = torch.equal(k_rounds, rounds)
    c_np = cost.cpu().numpy().astype(np.float64)
    opt = np.array([c[linear_sum_assignment(c)].sum() for c in c_np])
    span = c_np.max(axis=(1, 2)) - c_np.min(axis=(1, 2))
    eps_last = np.maximum(1e-5, np.maximum(span, 1e-5) * 0.5 / 6.0**7)
    gap = out.cpu().numpy() - opt
    tol_opt = N * eps_last + 1e-4
    ok = err <= 1e-4 and same_rounds and bool(np.all(gap >= -1e-4)) and bool(np.all(gap <= tol_opt))
    log(f"[kernels] K2 {label} (variant {k2.auction_variant(N)}): max_abs_err vs plain={err:.3e} "
        f"(tol 1e-4), rounds {'equal' if same_rounds else 'DIFFER'} (mean "
        f"{rounds.float().mean().item():.1f}, max {int(rounds.max().item())}), vs scipy "
        f"max={gap.max():.3e} (tol {tol_opt.max():.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 disagrees ({label})")
    if pallas_cap:
        # the Pallas kernel's own round cap (8N per phase), for the record: how
        # often its diagonal fallback misses the optimum on these inputs
        capped, rounds8 = k2.auction_assignment_cost_plain(cost, iters_per_phase=8 * N,
                                                           return_iters=True)
        miss = capped.cpu().numpy() - opt
        log(f"[kernels] K2 {label} with the Pallas cap 8N: {int(np.sum(miss > tol_opt))} of {B} "
            f"miss scipy (worst {miss.max():.3e}), rounds/problem="
            f"{rounds8.float().mean().item():.1f}")
    if not timed:
        return {}
    device_ms = kt.graph_ms(lambda c: k2.auction_assignment_cost(c), (cost,), 20)
    ms = kt.cuda_ms(lambda: k2.auction_assignment_cost(cost), 20)
    nbytes = B * N * N * 4 + B * 4
    flops = int(rounds.sum().item()) * 7 * N * N  # per round: bidder sweep 6N^2, object sweep N^2
    slowest = int(rounds.max().item())
    row = dict(max_abs_err=err, device_ms=device_ms, ms=ms, plain_ms=plain_ms, library_ms=None,
               rounds_slowest=slowest, us_per_round=device_ms * 1e3 / slowest,
               **bound_row(device_ms, nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS))
    log(f"[kernels] K2 {label}: device {device_ms:.5f} ms cold ({row['bound_share']:.2%} of the "
        f"bound {row['bound_ms']:.5f} ms, {row['bound_by']}), slowest problem {slowest} rounds, "
        f"{row['us_per_round']:.4f} us a round; eager {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return row


def check_k2(dev) -> None:
    """K2 at the scorer's shapes: B = 80 and 480 (query, candidate) pairs,
    padded N in {8, 32, 64}, costs built as the harness builds them; the
    sizes around each variant's edge (31, 32, 33, 224, 225, 238, 239, 300),
    uniform costs with tied rows and columns, and a constant block. Then the
    timed shapes of ``kernel_timing.k2_cases``, on each side of N = 238."""
    import torch

    from multimodalspectraltransformer_torch.rank import matching

    rng = np.random.default_rng(0)
    for B, n_max in ((80, 8), (80, 32), (80, 64), (480, 8), (480, 32)):
        cost, _ = matching.pairwise_cost(*kt.peak_lists(rng, B, n_max), device=dev)
        measure_k2(cost, f"B={B} N={cost.shape[1]}", timed=False)
    for N in (31, 32, 33, 224, 225, 238, 239, 300):
        B = 16 if N <= 64 else 3
        cost = torch.from_numpy(kt.edge_costs(rng, B, N)).to(dev)
        measure_k2(cost, f"B={B} N={N} ties + constant block", timed=False, pallas_cap=False)
    for label, cost in kt.k2_cases(dev, matching.pairwise_cost):
        measure_k2(cost, label, timed=True, pallas_cap=label.startswith("HSQC"))


def measure_k3(q, kv, bias, n_live: int, rtol: float, label: str, timed: bool = True) -> dict:
    """Hold K3 against its plain version on (q, kv, bias, n_live); with
    ``timed`` also time the kernel (cold device time and eager), the plain
    version and SDPA with the same bias as its mask, and compute the bound
    from what this bias needs: the cache columns of b that some beam of b
    attends to (every head of b shares the bias), q, out and the bias rows;
    the flops of the (b, k, column) triples it keeps. The bound of reading
    every live column, which the cache's layout forces (csrc/beam_attention.cu),
    is kept beside it as ``all_columns_bound_ms``."""
    import torch
    import torch.nn.functional as F

    from multimodalspectraltransformer_torch.ops import beam_attention as k3

    out = k3.beam_attention(q, kv, bias, n_live)
    ref = k3.beam_attention_plain(q, kv, bias, n_live)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = rtol * max(1.0, ref.float().abs().max().item())
    log(f"[kernels] K3 {label}: max_abs_err={err:.3e} tol={tol:.1e} {'ok' if err <= tol else 'FAIL'}")
    if not err <= tol:
        raise AssertionError(f"K3 disagrees with its plain version ({label})")
    if not timed:
        return {}
    B, H, K, Dh = q.shape
    device_ms = kt.graph_ms(lambda q_, kv_, b_: k3.beam_attention(q_, kv_, b_, n_live),
                            (q, kv, bias), 200)
    ms = kt.cuda_ms(lambda: k3.beam_attention(q, kv, bias, n_live), 200)
    plain_ms = kt.cuda_ms(lambda: k3.beam_attention_plain(q, kv, bias, n_live), 50)
    k_live = kv[:, :, :Dh, :n_live].transpose(-1, -2).contiguous()
    v_live = kv[:, :, Dh:, :n_live].transpose(-1, -2).contiguous()
    mask = bias[:, None, :, :n_live]
    lib_ms = kt.cuda_ms(lambda: F.scaled_dot_product_attention(q, k_live, v_live, attn_mask=mask,
                                                               scale=1.0), 50)
    kept = torch.isfinite(bias[:, :, :n_live])  # [B, K, n_live]
    needed_cols = int(kept.any(dim=1).sum().item())  # (b, column) pairs some beam attends to
    small = (2 * B * H * K * Dh + B * K * n_live) * q.element_size()  # q, out, bias rows
    col_bytes = H * 2 * Dh * q.element_size()  # one column of b's cache, all heads
    flops = H * int(kept.sum().item()) * (4 * Dh + 4)  # q.k, p.v multiply-adds, bias, max, exp, sum
    all_cols_ms = (small + col_bytes * B * n_live) / HBM_BYTES_PER_S * 1e3
    row = dict(max_abs_err=err, device_ms=device_ms, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **bound_row(device_ms, (small + col_bytes * needed_cols) / HBM_BYTES_PER_S,
                           flops / F32_FLOPS),
               all_columns_bound_ms=all_cols_ms, all_columns_share=all_cols_ms / device_ms)
    log(f"[kernels] K3 {label}: device {device_ms:.5f} ms cold ({row['all_columns_share']:.1%} of "
        f"the all-columns bound {all_cols_ms:.5f} ms, {row['bound_share']:.1%} of the bound "
        f"{row['bound_ms']:.5f} ms, {row['bound_by']}; {needed_cols} of {B * n_live} columns "
        f"needed), eager {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms")
    return row


def check_k3(dev) -> dict:
    """K3 at more than 16 beams (two groups), at head size 16, and at
    T = 50, K = 5, where a cache row of M = 250 columns is not a multiple of
    16 bytes and the kernel loads its tiles without cp.async; then the timed
    shapes of ``kernel_timing.k3_cases`` (beam mode's B=128, H=16, K=5,
    Dh=8, T=128, and K=10 at B=32), at pos 0, 63 and 127 (near the end for
    T = 50): fp32 (1e-5 relative) and bf16 (2^-7: the plain version rounds
    the probabilities to bf16 as the Pallas kernel does, the kernel's online
    softmax cannot). At beam mode's shape, bf16, pos 127 the cold timer is
    checked against torch.profiler's kernel time. Returns the bf16
    beam-mode row at pos 63, the mean position of a 128-step decode."""
    import torch

    from multimodalspectraltransformer_torch.decode import functional
    from multimodalspectraltransformer_torch.ops import beam_attention as k3

    H = 16
    gen = torch.Generator(device=dev).manual_seed(3)
    for B, K, Dh, T in ((32, 20, 8, 128), (32, 5, 16, 128), (16, 20, 16, 128), (16, 5, 8, 50),
                        (16, 5, 16, 50)):
        q32 = torch.randn(B, H, K, Dh, generator=gen, device=dev) / Dh**0.5
        kv32 = torch.randn(B, H, 2 * Dh, T * K, generator=gen, device=dev)
        for pos in (0, 63, T - 1) if T > 63 else (0, T // 2, T - 1):
            bias32 = kt.ancestry_bias(functional.ancestry_bias, gen, B, K, T, pos, torch.float32,
                                      dev)
            for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
                label = f"B={B} K={K} Dh={Dh} T={T} {str(dtype)[6:]} pos={pos}"
                args = (q32.to(dtype), kv32.to(dtype), bias32.to(dtype))
                measure_k3(*args, (pos + 1) * K, rtol, label, timed=False)
    rows = {}
    for label, q, kv, bias, n_live in kt.k3_cases(dev, functional.ancestry_bias):
        rtol = 1e-5 if q.dtype == torch.float32 else 2.0**-7
        rows[label] = measure_k3(q, kv, bias, n_live, rtol, label, timed=True)
        if label == "B=128 K=5 Dh=8 bfloat16 pos=127":
            prof = kt.profiler_ms(lambda q_, kv_, b_: k3.beam_attention(q_, kv_, b_, n_live),
                                  (q, kv, bias), 200, "beam_attention")
            log(f"[kernels] K3 {label}: cold device time {rows[label]['device_ms']:.5f} ms "
                f"by CUDA events around the graph, "
                f"{'not measured' if prof is None else f'{prof:.5f} ms'} by torch.profiler")
    return rows["B=128 K=5 Dh=8 bfloat16 pos=63"]


def measure_e1(grad, ids, V: int, label: str, timed: bool) -> dict:
    """Hold E1 (the wrapper: stable sort and kernel) against its plain
    version on (grad, ids) computed in float64: every element within 1e-6 of
    its table row's largest magnitude for a float32 gradient, within one
    bfloat16 rounding more (2^-8 + 1e-6 of it) for a bfloat16 one (the
    float32 sum is rounded once to bfloat16), within 1e-12 for a float64
    one (phase 10's tensor-parallel check steps in float64); a row no id
    reaches exactly 0; a second call bit for bit the first. The difference from the
    plain version in the gradient's own dtype (a float32 ``index_add_``,
    whose sum order on the card varies) is logged beside it. With ``timed``
    also time E1 (cold device time and eager), the plain version and
    ``aten.embedding_dense_backward`` (PyTorch's backward of ``F.embedding``),
    and compute the bound: the gradient and the ids read once, the table's
    gradient written once, over the memory rate."""
    import torch

    from multimodalspectraltransformer_torch.ops import embedding_grad as e1

    out = e1.embedding_grad(grad, ids, V)
    again = e1.embedding_grad(grad, ids, V)
    ref = e1.embedding_grad_plain(grad.double(), ids, V)
    plain = e1.embedding_grad_plain(grad, ids, V)
    torch.cuda.synchronize()
    rtol = {torch.float32: 1e-6, torch.bfloat16: 2.0**-8 + 1e-6,
            torch.float64: 1e-12}[grad.dtype]
    diff = (out.double() - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True)
    rel = float((diff / scale.clamp_min(1e-300)).max())
    unreached = torch.ones(V, dtype=torch.bool, device=ids.device)
    unreached[ids.reshape(-1)] = False
    zero = bool((out[unreached] == 0).all())
    same = torch.equal(out, again)
    err = float(diff.max())
    ok = bool((diff <= rtol * scale).all()) and zero and same and out.dtype == grad.dtype
    log(f"[kernels] E1 {label}: max_abs_err={err:.3e} (max {rel:.2e} of its row's largest, tol "
        f"{rtol:.1e}), against the plain version in {str(grad.dtype)[6:]} "
        f"{float((out.double() - plain.double()).abs().max()):.3e}; {int(unreached.sum())} rows "
        f"unreached, {'all 0' if zero else 'NOT 0'}; a second call "
        f"{'bit for bit the same' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"E1 disagrees with its plain version or with itself ({label})")
    if not timed:
        return {}
    N, D = ids.numel(), grad.shape[-1]
    device_ms = kt.graph_ms(lambda g_, i_: e1.embedding_grad(g_, i_, V), (grad, ids), 200)
    ms = kt.cuda_ms(lambda: e1.embedding_grad(grad, ids, V), 200)
    plain_ms = kt.cuda_ms(lambda: e1.embedding_grad_plain(grad, ids, V), 50)
    lib_ms = kt.cuda_ms(lambda: torch.ops.aten.embedding_dense_backward(grad, ids, V, -1, False),
                        50)
    nbytes = N * D * grad.element_size() + N * ids.element_size() + V * D * grad.element_size()
    row = dict(max_abs_err=err, max_rel_err=rel, device_ms=device_ms, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms,
               **bound_row(device_ms, nbytes / HBM_BYTES_PER_S, N * D / F32_FLOPS))
    log(f"[kernels] E1 {label}: device {device_ms:.5f} ms cold ({row['bound_share']:.1%} of the "
        f"bound {row['bound_ms']:.5f} ms, {row['bound_by']}), eager {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, embedding_dense_backward {lib_ms:.4f} ms")
    return row


def check_e1(dev) -> dict:
    """E1 at the trained tables' shapes (``kernel_timing.E1_TIMED``) with
    float32, bfloat16 and float64 gradients, at the decoder's positions over the whole
    batch (64 x 63) and at CLIP's longest text (256 x 128), all ids of one
    value and a table row per id; then the timed shapes, each in its training
    dtype. Returns the row of the MMT's target-token table."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = [(t, V, D, rc, draw) for t, V, D, rc, _, draw in kt.E1_TIMED]
    shapes += [("MMT pe_trg, whole batch", 128, 128, (64, 63), "arange"),
               ("CLIP word, longest text", 600, 768, (256, 128), 0.5),
               ("CLIP position, longest text", 130, 768, (256, 128), "roberta"),
               ("one id", 43, 128, (64, 63), 1.0), ("a row per id", 600, 64, (1, 600), "arange")]
    for table, V, D, (rows, cols), draw in shapes:
        ids = kt.e1_ids(gen, V, rows, cols, draw, dev)
        grad = torch.randn(rows, cols, D, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            measure_e1(grad.to(dtype), ids, V, f"{table} V={V} D={D} N={rows * cols} "
                       f"{str(dtype)[6:]}", timed=False)
    rows = {label: measure_e1(grad, ids, V, label, timed=True)
            for label, grad, ids, V in kt.e1_cases(dev)}
    return rows["MMT embed_trg V=43 D=128 N=4032 bfloat16"]


# ---------------------------------------------------------------------------
# phases 3-4: the main path and its checks
# ---------------------------------------------------------------------------

def main_path(dev, n_mols: int = 8, fanout: int = 128):
    """Drive evaluate_molecules once (after a warm-up) with the launch
    counters reset just before; return the counts, the HSQC cost tensor the
    run's scorer solved (rebuilt from its pairs), and the run's records,
    model, decode configuration and results."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.decode import samplers
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.rank import clip, matching
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig

    cfg = ModelConfig()
    t0 = time.perf_counter()
    records = factory.simulate_records(molrandom.random_corpus(2 * n_mols, seed=123)[:n_mols], device=dev)
    model = mmt.load_model(PHASE3, cfg, device=dev)
    clip_bundle = clip.load_bundle(CLIP_R4, device=dev)
    torch.cuda.synchronize()
    log(f"[main] set-up: {len(records)} records simulated, phase3 and clip_r4 loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    dcfg = DecodeConfig(max_len=64, fanout=fanout, multinom_runs=10, max_temp_rounds=5,
                        compute_dtype="bfloat16")
    run = dict(clip_bundle=clip_bundle, clip_block=dcfg.multinom_runs, device=dev)

    t0 = time.perf_counter()
    harness.evaluate_molecules(records, model, dcfg, seed=1, **run)  # warm-up
    log(f"[main] warm-up run: {time.perf_counter() - t0:.2f} s")

    k1.reset_launches()
    k2.reset_launches()
    t0 = time.perf_counter()
    results, summary = harness.evaluate_molecules(records, model, dcfg, seed=0, **run)
    wall = time.perf_counter() - t0
    launches = {"K1": k1.launches, "K2": k2.launches}
    stages = " ".join(f"{k}={v:.3f}" for k, v in summary.stage_seconds.items())
    log(f"[main] {summary.n} molecules in {wall:.2f} s: {summary.mols_per_sec:.3f} mols/s, "
        f"top-1 {summary.top_k_accuracy[1]:.3f}, top-5 {summary.top_k_accuracy[5]:.3f}, "
        f"greedy validity {summary.greedy_validity:.3f}, mns_exact {summary.mns_exact:.3f}")
    log(f"[main] stage seconds: {stages}")
    log(f"[main] launches: K1={launches['K1']} K2={launches['K2']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path launched kernel {name} no time")

    # ---- what came out: shapes, finiteness, errors against scipy ----
    if summary.n != len(records) or len(results) != len(records):
        raise AssertionError(f"{len(results)} results for {len(records)} records")
    n_cands = sum(len(r.candidates) for r in results)
    if n_cands == 0 or summary.mns_exact <= 0.0:
        raise AssertionError(f"no useful candidates: {n_cands} candidates, mns_exact {summary.mns_exact}")
    clip_stage(clip_bundle[1], results, summary, dcfg.multinom_runs)
    sims = {sr.smiles: sr for sr in factory.simulate_records(
        [c.smiles for r in results for c in r.candidates], device=dev)}
    rec_by_target = {r.smiles: r for r in records}
    pairs = []  # (query peaks, candidate peaks, the harness's error)
    for res in results:
        rec = rec_by_target[res.target]
        for c in res.candidates:
            sr = sims.get(c.smiles)
            if sr is not None and sr.hsqc:
                pairs.append((np.asarray(rec.hsqc), np.asarray(sr.hsqc), c.hsqc_error))
    cost, denom = matching.pairwise_cost([p[0] for p in pairs], [p[1] for p in pairs], device=dev)
    n_pad = cost.shape[1]
    worst = 0.0
    for (q, c, err), cm, d in zip(pairs, cost.cpu().numpy().astype(np.float64), denom):
        if not np.isfinite(err):
            raise AssertionError("a simulated candidate has no HSQC error")
        opt = cm[linear_sum_assignment(cm)].sum() / d
        worst = max(worst, abs(err - opt) * d - n_pad * 2e-5)
    log(f"[check] {len(pairs)} HSQC errors (N={n_pad}) against scipy: worst excess over "
        f"N*eps = {worst:.2e} (tol 1e-4)")
    if worst > 1e-4:
        raise AssertionError("spectral errors disagree with scipy's optimum")

    # ---- the greedy decode through K1 against the CPU's plain path ----
    feats = [f for f in (dp.featurize(r, cfg) for r in records) if f is not None]
    enc = model.encode(mmt.MMTBatch(*dp.collate(feats).inputs).to(dev))
    params = model.state_dict()
    g_dev = samplers.greedy_decode(params, cfg, enc.memory, enc.memory_key_padding_mask, 1.0, 64,
                                   device=dev)
    g_cpu = samplers.greedy_decode({k: v.cpu() for k, v in params.items()}, cfg, enc.memory.cpu(),
                                   enc.memory_key_padding_mask.cpu(), 1.0, 64, device="cpu")
    same = torch.equal(g_dev.tokens.cpu(), g_cpu.tokens)
    log(f"[check] greedy fp32 tokens of {len(feats)} molecules, card (K1) vs CPU (plain): "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("greedy decode on the card differs from the CPU's plain path")
    check_clip(clip_bundle, results, enc.fingerprint)
    return launches, cost, (records, model, dcfg, results)


def clip_tokens_flops(ccfg, n_blocks: int, width: int) -> tuple[int, float]:
    """Tokens the CLIP tower runs (every position of every padded block) and
    their operations: per token 2 * L * (4 d^2 + 2 d ffn) for the projections
    and the feed-forward, plus 4 * L * T * d for the attention's two products;
    the pooler and heads, once per candidate, are left out (under 0.1%)."""
    L, d, T = ccfg.text_layers, ccfg.text_hidden, ccfg.text_max_len
    tokens = n_blocks * width * T
    per_token = 2 * L * (4 * d * d + 2 * d * ccfg.text_ffn) + 4 * L * T * d
    return tokens, float(tokens) * per_token


def clip_stage(ccfg, results, summary, clip_block: int) -> None:
    """Every candidate has finite CLIP scores; log the stage's seconds,
    tokens, FLOPs and their share of the card's float32 peak."""
    from multimodalspectraltransformer_torch.eval import harness

    sizes = [len(r.candidates) for r in results if r.candidates]
    bad = [c.smiles for r in results for c in r.candidates
           if not (np.isfinite(c.clip_loss) and np.isfinite(c.clip_dot))]
    if bad or not sizes:
        raise AssertionError(f"CLIP: {len(bad)} of {sum(sizes)} candidates without finite scores")
    width = harness.clip_block_width(max(sizes), clip_block)
    tokens, flops = clip_tokens_flops(ccfg, len(sizes), width)
    secs = summary.stage_seconds["clip"]
    log(f"[main] CLIP stage: {secs:.4f} s for {len(sizes)} blocks of {width} candidates, "
        f"{tokens} tokens, {flops / 1e12:.4f} TFLOP, {flops / secs / 1e12:.2f} TFLOP/s = "
        f"{flops / secs / F32_FLOPS:.1%} of the float32 peak; {sum(sizes)} candidates, all "
        f"with finite clip_loss and clip_dot")


def check_clip(clip_bundle, results, fingerprints) -> None:
    """``score_candidates_batch`` on the card against the port on the CPU, on
    the main path's first three molecules' candidates (10 each, the last
    repeated) and their fingerprints, in float32 (1e-4 * max(1, |x|): float32
    products summed in another order) and bfloat16 (2^-7 * max|cb| * max|mt|:
    a rounding to bfloat16 that flips moves a logit by up to 2^-8 of the
    embeddings' norm product, tests/test_torch_clip.py)."""
    import copy

    import torch

    from multimodalspectraltransformer_torch.rank import clip
    from multimodalspectraltransformer_torch.train.contrastive import clip_tokenize

    model, ccfg = clip_bundle
    picked = [i for i, r in enumerate(results) if r.candidates][:3]
    if len(picked) < 2:
        raise AssertionError("CLIP check: fewer than 2 molecules with candidates")
    smis = []
    for i in picked:
        c = [x.smiles for x in results[i].candidates][:10]
        smis += c + [c[-1]] * (10 - len(c))
    toks, mask = clip_tokenize(smis, ccfg.text_max_len)
    shape = (len(picked), 10, ccfg.text_max_len)
    toks = torch.from_numpy(toks).reshape(shape)
    mask = torch.from_numpy(mask).reshape(shape)
    fps = fingerprints[picked].float().cpu()
    dev = next(model.parameters()).device
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        cb = cpu_model.embed_text(toks.reshape(-1, shape[-1]), mask.reshape(-1, shape[-1]))
        mt = cpu_model.embed_spectrum(fps)
    norm_product = float(cb.norm(dim=-1).max() * mt.norm(dim=-1).max())
    for dtype in (None, "bfloat16"):
        card = clip.score_candidates_batch(model, ccfg, toks.to(dev), mask.to(dev), fps.to(dev),
                                           compute_dtype=dtype)
        host = clip.score_candidates_batch(cpu_model, ccfg, toks, mask, fps, compute_dtype=dtype)
        worst, ok = 0.0, True
        for a, b in zip(card, host):
            a, b = a.cpu().double(), b.double()
            diff = (a - b).abs()
            bound = (1e-4 * b.abs().clamp_min(1.0) if dtype is None
                     else torch.full_like(b, 2.0**-7 * max(1.0, norm_product)))
            worst = max(worst, diff.max().item())
            ok = ok and bool((diff <= bound).all()) and bool(torch.isfinite(a).all())
        tol = "1e-4 relative" if dtype is None else f"{2.0**-7 * norm_product:.3f}"
        log(f"[check] CLIP score_candidates_batch {dtype or 'float32'}, {len(picked)} molecules x "
            f"10 candidates, card vs CPU: max_abs_err={worst:.3e} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"CLIP scores on the card differ from the CPU ({dtype})")


# ---------------------------------------------------------------------------
# phase 5: the beam path
# ---------------------------------------------------------------------------

def beam_path(dev, model, records, dcfg, main_results) -> int:
    """Beam mode, its float32 tokens against the materialized search and the
    CPU, and the harness with beam and greedy hypotheses in the pools.
    Returns K3's launches in one beam-mode call."""
    import torch

    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.decode import samplers
    from multimodalspectraltransformer_torch.eval import beam_bench, harness
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import beam_attention as k3
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.utils import vocab

    cfg = model.cfg
    n, K, L = beam_bench.BATCH, beam_bench.BEAM, beam_bench.MAX_LEN
    # (a) beam mode
    batch = beam_bench.beam_mode_batch(cfg, n, device=dev)
    stages, _ = beam_bench.run(model, batch, K, L)
    log(f"[beam] warm-up call: {stages['total']:.2f} s")
    for call in range(2):
        k1.reset_launches()
        k2.reset_launches()
        k3.reset_launches()
        stages, res = beam_bench.run(model, batch, K, L)
        launches = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}
        s = res.scores
        log(f"[beam] beam mode call {call}: {n} molecules, beam {K}, {L} steps, bf16: "
            f"{stages['total']:.3f} s, {n / stages['total']:.3f} mols/s; stage seconds: "
            f"encode={stages['encode']:.3f} beam={stages['beam']:.3f}; launches: K1={launches['K1']} "
            f"K2={launches['K2']} K3={launches['K3']}")
        if launches["K3"] != cfg.num_decoder_layers * L:
            raise AssertionError(f"beam mode launched K3 {launches['K3']} times, not "
                                 f"{cfg.num_decoder_layers * L}")
        if (res.tokens.shape != (n, K, L) or not bool(torch.isfinite(s).all())
                or not bool((s[:, 1:] <= s[:, :-1]).all())):
            raise AssertionError("beam mode: beams of the wrong shape, non-finite or unsorted scores")
    k3_launches = launches["K3"]

    # (b) float32 tokens: K3 on the card, K1 (materialized) on the card, the CPU's plain path
    sub = mmt.MMTBatch(*(x[:8] for x in batch))
    enc = model.encode(sub)
    params = model.state_dict()
    mem, kpm = enc.memory, enc.memory_key_padding_mask
    t0 = time.perf_counter()
    a = samplers.beam_search(params, cfg, mem, kpm, K, 1.0, L, device=dev)
    b = samplers.beam_search_materialized(params, cfg, mem, kpm, K, 1.0, L, device=dev)
    c = samplers.beam_search({k: v.cpu() for k, v in params.items()}, cfg, mem.cpu(), kpm.cpu(), K,
                             1.0, L, device="cpu")
    same_b = torch.equal(a.tokens.cpu(), b.tokens.cpu())
    same_c = torch.equal(a.tokens.cpu(), c.tokens)
    d_score = max((a.scores.cpu() - b.scores.cpu()).abs().max().item(),
                  (a.scores.cpu() - c.scores).abs().max().item())
    log(f"[beam] fp32 beam tokens of 8 molecules, card (K3) vs card materialized (K1): "
        f"{'identical' if same_b else 'DIFFER'}; vs CPU (plain): {'identical' if same_c else 'DIFFER'}; "
        f"max score difference {d_score:.2e} (tol 1e-4); {time.perf_counter() - t0:.1f} s")
    if not (same_b and same_c and d_score <= 1e-4):
        raise AssertionError("fp32 beam search on the card differs")

    # (c) the harness with beam and greedy hypotheses in the pools
    bcfg = dataclasses.replace(dcfg, beam_candidates=K, greedy_in_pool=True)
    k1.reset_launches()
    k2.reset_launches()
    k3.reset_launches()
    results, summary = harness.evaluate_molecules(records, model, bcfg, seed=0, device=dev)
    launches = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}
    stages = " ".join(f"{k}={v:.3f}" for k, v in summary.stage_seconds.items())
    log(f"[beam] evaluate_molecules with beam_candidates={K}, greedy_in_pool: {summary.n} molecules, "
        f"{summary.mols_per_sec:.3f} mols/s, top-1 {summary.top_k_accuracy[1]:.3f}, "
        f"mns_exact {summary.mns_exact:.3f}; launches: K1={launches['K1']} K2={launches['K2']} "
        f"K3={launches['K3']}")
    log(f"[beam] stage seconds: {stages}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the harness with beam candidates launched kernel {name} no time")
    # the beams the harness merged, decoded again, and the greedy hypothesis of
    # the same run: every one that passes the canonical and MW gates is in its
    # molecule's pool
    feats = [f for f in (dp.featurize(r, cfg) for r in records) if f is not None]
    enc = model.encode(mmt.MMTBatch(*dp.collate(feats).inputs).to(dev))
    beams = samplers.beam_search(params, cfg, enc.memory, enc.memory_key_padding_mask, K, 1.0,
                                 bcfg.max_len, compute_dtype=bcfg.compute_dtype, device=dev)
    toks = beams.tokens.cpu().numpy()

    def gated(can, f) -> bool:
        mw = chem.mol_wt(can) if can is not None else None
        return mw is not None and (not bcfg.mw_filter
                                   or abs(round(mw) - round(float(f["mw"]))) <= bcfg.mw_delta)

    n_gated = {"beam": 0, "greedy": 0}
    for i, (res, f) in enumerate(zip(results, feats)):
        pool = {c.smiles for c in res.candidates}
        beam_cans = chem.batch_canonicalize([vocab.ids_to_smiles(r) for r in toks[i]])
        greedy_can = chem.batch_canonicalize([res.greedy])[0]
        for kind, cans in (("beam", beam_cans), ("greedy", [greedy_can])):
            for can in cans:
                if not gated(can, f):
                    continue
                n_gated[kind] += 1
                if can not in pool:
                    raise AssertionError(f"{kind} hypothesis {can} passed the gates but is not in "
                                         f"the pool")
    before = sum(len(r.candidates) for r in main_results)
    after = sum(len(r.candidates) for r in results)
    log(f"[check] pools: {before} candidates without beam, {after} with beam and greedy; "
        f"{n_gated['beam']} beam and {n_gated['greedy']} greedy hypotheses pass the gates, all "
        f"in their pools")
    for kind, n in n_gated.items():
        if n == 0:
            raise AssertionError(f"no {kind} hypothesis passed the gates")
    return k3_launches


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def _train_batch(cfg, n: int, seed: int, dev):
    """A featurized batch of ``n`` synthetic records on ``dev``."""
    from multimodalspectraltransformer_torch.data import pipeline as dp

    recs = dp.synthetic_dataset(n, seed=seed)
    return dp.to_device(dp.collate([dp.featurize(r, cfg) for r in recs]), dev)


def resolved_gradient(g, g_other, adam_eps: float = 1e-8):
    """Where AdamW's step is fixed by the gradient ``g`` and not by its
    rounding, given a second computation ``g_other`` of it: zero in both, or
    at least 1e-4 of the leaf's largest magnitude (the bound to which two
    float32 gradients are held) and at least 100 eps (where g / (|g| + eps)
    no longer depends on eps). A gradient zero in one computation and
    rounding noise in the other is not resolved: AdamW's first step moves
    the parameter by lr * g / (|g| + eps) for the noise."""
    a = g.abs()
    return ((g == 0) & (g_other == 0)) | ((a >= 1e-4 * a.max()) & (a >= 100 * adam_eps))


def train_step_card_vs_cpu(dev, batch_size: int = 8) -> None:
    """Check 1: one fp32 train step from phase3 (dropout off, TF32 off, lr
    3e-5) on the card and on the CPU. The losses agree within 1e-5
    relative; each gradient leaf within 1e-4 of its largest magnitude; the
    parameters within 1e-6 wherever the gradient is resolved
    (``resolved_gradient``). Elsewhere AdamW's first step,
    lr * g / (|g| + eps), turns rounding noise into an update of up to lr
    with either sign (the attention key biases, whose gradient is zero in
    exact arithmetic): those stay within 2 lr and are under 20% of the
    parameters."""
    import copy

    import torch

    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.config import (MMTConfig, ModelConfig,
                                                                  TrainConfig)

    cfg = MMTConfig(model=ModelConfig(dropout=0.0), train=TrainConfig(learning_rate=3e-5))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        host = mmt.load_model(PHASE3, cfg.model, device="cpu")
        card = copy.deepcopy(host).to(dev)
        out = {}
        for name, model, d in (("cpu", host, "cpu"), ("card", card, dev)):
            state = st.create_state(cfg.train, model)
            state, m = step.train_step(cfg, state, _train_batch(cfg.model, batch_size, 11, d))
            out[name] = (float(m.loss), {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                         {k: v.cpu() for k, v in model.state_dict().items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    compare_steps(f"[train] check 1, one fp32 step from phase3 (batch {batch_size}, TF32 off)",
                  out, cfg.train.learning_rate)


def compare_steps(label: str, out: dict, lr: float) -> None:
    """Hold a step on the card (``out["card"]``) to the CPU's
    (``out["cpu"]``), each (loss, gradients, parameters after the step): the
    loss within 1e-5 relative; each gradient leaf within 1e-4 of its largest
    magnitude; the parameters within 1e-6 wherever the gradient is resolved
    (``resolved_gradient``), within 2 lr elsewhere, where under 20% of the
    elements may lie."""
    import torch

    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = out["cpu"], out["card"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_err = max(((g_card[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                   for k, g in g_cpu.items())
    worst_resolved = worst = 0.0
    n_all = n_unresolved = 0
    where = ""
    for k, p in p_cpu.items():
        g = g_cpu[k]
        resolved = resolved_gradient(g, g_card[k])
        diff = (p_card[k] - p).abs()
        worst = max(worst, diff.max().item())
        if resolved.any() and diff[resolved].max().item() > worst_resolved:
            worst_resolved = diff[resolved].max().item()
            i = int(torch.where(resolved, diff, torch.zeros_like(diff)).argmax())
            where = (f" (at {k}[{i}]: gradient {g.flatten()[i].item():.3e} on the CPU, "
                     f"{g_card[k].flatten()[i].item():.3e} on the card)")
        n_all += p.numel()
        n_unresolved += int((~resolved).sum())
    ok = (loss_rel <= 1e-5 and grad_err <= 1e-4 and worst_resolved <= 1e-6 and worst <= 2 * lr
          and n_unresolved < 0.2 * n_all)
    log(f"{label}, card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}, tol 1e-5); "
        f"gradients within {grad_err:.2e} of their leaf's max (tol 1e-4); params max diff "
        f"{worst_resolved:.2e} where the gradient is resolved{where} (tol 1e-6), {worst:.2e} over "
        f"all (tol {2 * lr:.0e}, {n_unresolved} of {n_all} unresolved) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the step on the card differs from the CPU")


def resume_exact(dev) -> None:
    """Check 3: fp32 with dropout on, from phase3: 3 steps, a checkpoint, 2
    more; a fresh state restored from the checkpoint takes the same 2 steps.
    Parameters and loss within 1e-6 (the steps are the same kernels on the
    same inputs, so 0 is expected)."""
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import checkpoint as ckpt
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, TrainConfig

    cfg = MMTConfig(train=TrainConfig(learning_rate=3e-5))
    batch = _train_batch(cfg.model, 16, 12, dev)
    fresh = lambda: st.create_state(cfg.train, mmt.load_model(PHASE3, cfg.model, device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        mgr = ckpt.CheckpointManager(tmp, keep=1)
        state = fresh()
        for _ in range(3):
            state, _ = step.train_step(cfg, state, batch, seed=5)
        mgr.save(state)
        for _ in range(2):
            state, m_live = step.train_step(cfg, state, batch, seed=5)
        restored = mgr.restore(fresh())
        for _ in range(2):
            restored, m_rest = step.train_step(cfg, restored, batch, seed=5)
    diff = max((a - b).abs().max().item() for a, b in zip(state.model.state_dict().values(),
                                                          restored.model.state_dict().values()))
    loss_diff = abs(float(m_live.loss) - float(m_rest.loss))
    ok = restored.step == state.step == 5 and diff <= 1e-6 and loss_diff <= 1e-6
    log(f"[train] check 3, resume at step 3 then 2 steps (fp32, dropout on) vs 5 uninterrupted: "
        f"params max diff {diff:.2e}, loss diff {loss_diff:.2e} (tol 1e-6) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a resumed run differs from the uninterrupted one")


def _flops_per_step(cfg, state, batch) -> float:
    """FLOPs of one train step, counted by FlopCounterMode (forward and
    backward matrix products; the optimizer's elementwise work is not
    counted)."""
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.roofline import flop_count

    return flop_count(step.train_step, cfg, state, batch)


def time_steps(dev, loader, cfg, init, warmup: int = 5, timed: int = 10) -> dict:
    """Median step time over ``timed`` steps after ``warmup``, with samples/s,
    target tokens/s (non-pad teacher-forced targets) and peak memory."""
    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step

    model = mmt.MultimodalTransformer(cfg.model)
    model.load_state_dict(init)
    state = st.create_state(cfg.train, model.to(dev))
    dd = loader.device_dataset(dev)
    rows, epoch = [], 0
    while len(rows) < warmup + timed:
        rows += list(loader.epoch_row_batches(epoch))
        epoch += 1
    rows = rows[: warmup + timed]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, tokens = [], [], []
    for idx in rows:
        b = dp.gather_rows(dd, idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step.train_step(cfg, state, b)
        losses.append(float(m.loss))  # waits for the step
        times.append(time.perf_counter() - t0)
        tokens.append(int((b.trg_tokens[:, 1:] != 0).sum()))
    peak = torch.cuda.max_memory_allocated()
    flops = _flops_per_step(cfg, state, dp.gather_rows(dd, rows[0]))
    ms = float(np.median(times[warmup:])) * 1e3
    return dict(step_ms=ms, samples_per_s=loader.batch_size / ms * 1e3,
                target_tokens_per_s=float(np.mean(tokens[warmup:])) / ms * 1e3,
                flops_per_step=flops, tflops_per_s=flops / ms * 1e-9, peak_bytes=peak,
                losses=losses)


def train_data(dev, mcfg):
    """The training phase's data and start: ``random_corpus(256, seed=3133)``
    simulated on the card, the last 10% for validation, the rest augmented
    2x with SMILES variants (the recipe that produced phase3),
    batch 64; phase3's parameters. Returns (train loader, validation loader,
    state dict, the simulated records)."""
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import convert
    from multimodalspectraltransformer_torch.sim import factory

    smiles = molrandom.random_corpus(256, seed=3133)
    recs = factory.simulate_records(smiles, sample_ids=[f"f{i}" for i in range(len(smiles))],
                                    device=dev)
    n_val = max(1, int(len(recs) * 0.1))
    train_recs = dp.augment_records(recs[:-n_val], 2, seed=0)
    opts = dp.FeaturizeOptions(use_given_smiles_form=True)
    loader = dp.Loader(train_recs, mcfg, batch_size=64, opts=opts)
    val = dp.Loader(recs[-n_val:], mcfg, batch_size=min(64, n_val), drop_remainder=False)
    return loader, val, convert.from_jax_params(convert.read_msgpack(PHASE3)), recs


# every auxiliary term of the generation metrics live (they add to no gradient)
GEN_TERMS = dict(sgnn_feedback=True, weight_mw=0.1, weight_sgnn=0.05, weight_tanimoto=0.2,
                 weight_validity=0.2)


def generation_metrics_card_vs_cpu(dev, records, n: int = 8, mcfg=None,
                                   params_path: str = PHASE3) -> None:
    """``generation_metrics`` on ``n`` records in fp32 (TF32 off), the model
    at ``mcfg``'s width from ``params_path``, every term live: the card's
    greedy generations (K1) are the CPU's (plain path) string for string, and
    every metric agrees within 1e-6 relative (NaN in both where one is)."""
    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.train import loop
    from multimodalspectraltransformer_torch.utils.config import (MMTConfig, ModelConfig,
                                                                  TrainConfig)

    cfg = MMTConfig(model=mcfg or ModelConfig(), train=TrainConfig(**GEN_TERMS))
    feats = [f for f in (dp.featurize(r, cfg.model) for r in records[:n]) if f is not None]
    batch = dp.collate(feats)
    out = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        model = mmt.load_model(params_path, cfg.model, device=d)
        b = dp.to_device(batch, d)
        k1.reset_launches()
        t0 = time.perf_counter()
        metrics = loop.generation_metrics(model, cfg, b, step=40)
        secs = time.perf_counter() - t0
        out[name] = (loop.greedy_generations(model, cfg, b)[0], metrics, secs, k1.launches)
    (g_cpu, m_cpu, s_cpu, _), (g_card, m_card, s_card, n_k1) = out["cpu"], out["card"]
    bad = [k for k, v in m_cpu.items()
           if not (np.isnan(v) and np.isnan(m_card[k]))
           and not abs(m_card[k] - v) <= 1e-6 * max(abs(v), 1e-12)]
    same = g_card == g_cpu
    log(f"[check] generation_metrics on {len(feats)} records (fp32), card (K1: {n_k1} launches, "
        f"{s_card:.2f} s) vs CPU ({s_cpu:.2f} s): generations {'identical' if same else 'DIFFER'}, "
        f"metrics {'equal within 1e-6' if not bad else f'DIFFER in {bad}'}: "
        + ", ".join(f"{k}={v:.6g}" for k, v in m_card.items()))
    if not same or bad or n_k1 <= 0:
        raise AssertionError("generation_metrics on the card differ from the CPU")


def train_phase(dev, card: str):
    """Phase 6 (see the module docstring); returns the simulated records."""
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.models import convert, mmt
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.ops import embedding_grad as e1
    from multimodalspectraltransformer_torch.train import checkpoint as ckpt
    from multimodalspectraltransformer_torch.train import loop, step
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig

    t_phase = time.perf_counter()
    mcfg = ModelConfig()
    loader, val, init, recs = train_data(dev, mcfg)
    bf16 = MMTConfig(model=mcfg, train=TrainConfig(learning_rate=3e-5, mixed_precision=True,
                                                   num_epochs=100, save_interval_steps=20,
                                                   **GEN_TERMS))
    fp32 = MMTConfig(model=mcfg, train=TrainConfig(learning_rate=3e-5))
    dd = loader.device_dataset(dev)
    log(f"[train] set-up: 256 molecules simulated, "
        f"{len(loader.records)} training records after 2x augmentation "
        f"({dd.trg_tokens.shape[0]} featurized, {len(loader)} batches of 64 an epoch), "
        f"{len(val.records)} validation records, in {time.perf_counter() - t_phase:.2f} s")

    rows = {}
    for name, cfg in (("bf16", bf16), ("fp32", fp32)):
        rows[name] = r = time_steps(dev, loader, cfg, init)
        peak = BF16_FLOPS if name == "bf16" else F32_FLOPS
        log(f"[train] {name} step at batch 64: median {r['step_ms']:.3f} ms after 5 warm-up steps, "
            f"{r['samples_per_s']:.1f} samples/s, {r['target_tokens_per_s']:.0f} target tokens/s, "
            f"{r['flops_per_step'] / 1e12:.4f} TFLOP a step, {r['tflops_per_s']:.2f} TFLOP/s "
            f"({r['tflops_per_s'] * 1e12 / peak:.1%} of the {name} peak), peak memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB; {card}")

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        k1.reset_launches()
        e1.reset_launches()
        t0 = time.perf_counter()
        res = loop.run_training(bf16, loader, val_loader=val, init_params=init,
                                checkpoint_dir=os.path.join(tmp, "ckpt"), max_steps=40, device=dev,
                                metrics_path=os.path.join(tmp, "metrics.jsonl"),
                                gen_metrics_every=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen_k1, train_e1 = k1.launches, e1.launches
        hist = [x for x in res.metrics.history if "train_loss" in x]
        vals = [x["val_loss"] for x in res.metrics.history if "val_loss" in x]
        saved = sorted(os.listdir(os.path.join(tmp, "ckpt")))
        export = os.path.join(tmp, "params.msgpack.gz")
        ckpt.export_params_msgpack(res.state.model, export, dtype=torch.bfloat16)
        back = convert.from_jax_params(convert.read_msgpack(export))
    log(f"[train] run_training bf16 from phase3, lr 3e-5: {res.steps} steps in {wall:.2f} s "
        f"({res.steps * 64 / wall:.1f} samples/s with validation and checkpoints), first loss "
        f"{hist[0]['train_loss']:.4f}, last {hist[-1]['train_loss']:.4f}, val losses "
        f"{', '.join(f'{v:.4f}' for v in vals)}, plateau scale {float(res.state.plateau.scale)}, "
        f"checkpoints {saved}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if res.steps != 40 or len(vals) < 2 or not saved:
        raise AssertionError("run_training did not take 40 steps over several epochs with "
                             "validation and checkpoints")
    gms = [x for x in res.metrics.history if "gen_validity" in x]
    for gm in gms:
        log(f"[train] generation metrics at step {gm['step']:.0f} (batch 64, greedy through K1): "
            + ", ".join(f"{k}={v:.6g}" for k, v in gm.items() if k != "step"))
    log(f"[train] launches in run_training: K1={gen_k1} (the generation metrics), E1={train_e1} "
        f"(the gradients of the MF, target-token and position tables, "
        f"{train_e1 / res.steps:g} a step)")
    if train_e1 != E1_A_STEP["mmt"] * res.steps:
        raise AssertionError(f"run_training launched E1 {train_e1} times in {res.steps} steps")
    if [gm["step"] for gm in gms] != [10, 20, 30, 40] or gen_k1 <= 0 or not all(
            np.isfinite([gm["sgnn_sim_error"], gm["aux_loss_total"]]).all() for gm in gms):
        raise AssertionError("run_training did not log finite generation metrics every 10 "
                             "steps through K1")
    # check 4: the bf16 export reads back as the parameters rounded to bf16
    mismatched = [k for k, v in res.state.model.state_dict().items()
                  if not torch.equal(back[k], v.cpu().to(torch.bfloat16).float())]
    log(f"[check] check 4, the bf16 params.msgpack.gz read back: {len(back)} leaves, "
        f"{len(mismatched)} differ from the parameters rounded to bf16")
    if mismatched:
        raise AssertionError(f"export differs from the bf16-rounded parameters: {mismatched[:3]}")

    train_step_card_vs_cpu(dev)

    # check 2: from the port's own init, 30 fp32 steps on one batch of 8 halve the loss
    cfg = MMTConfig(model=mcfg, train=TrainConfig(learning_rate=1e-3, weight_fp=0.1))
    state = st.create_state(cfg.train, mmt.init_model(mcfg, 0, dev))
    batch = _train_batch(mcfg, 8, 13, dev)
    overfit = [float(step.train_step(cfg, state, batch)[1].loss) for _ in range(30)]
    log(f"[train] check 2, 30 fp32 steps on one batch of 8 from the port's init: loss "
        f"{overfit[0]:.4f} -> {overfit[-1]:.4f} {'ok' if overfit[-1] < 0.5 * overfit[0] else 'FAIL'}")
    if not overfit[-1] < 0.5 * overfit[0]:
        raise AssertionError("30 steps on one batch did not halve the loss")

    resume_exact(dev)
    generation_metrics_card_vs_cpu(dev, val.records)

    # check 5: every loss finite
    losses = (rows["bf16"]["losses"] + rows["fp32"]["losses"] + overfit
              + [x["train_loss"] for x in hist] + vals)
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")
    log(f"[check] check 5: all {len(losses)} training and validation losses finite; the training "
        f"phase took {time.perf_counter() - t_phase:.1f} s")
    return recs, train_e1


# ---------------------------------------------------------------------------
# phase 7: the serving console
# ---------------------------------------------------------------------------

class _Http:
    """A threaded WSGI server of ``app`` on 127.0.0.1 (a free port) in a
    daemon thread, and the requests the phase sends it."""

    def __init__(self, app):
        import threading
        from socketserver import ThreadingMixIn
        from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

        class Server(ThreadingMixIn, WSGIServer):
            daemon_threads = True

        class Quiet(WSGIRequestHandler):
            def log_message(self, *args) -> None:
                pass

        self.httpd = make_server("127.0.0.1", 0, app, server_class=Server, handler_class=Quiet)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path: str) -> tuple[str, bytes]:
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.headers.get("Content-Type", ""), r.read()

    def post(self, path: str, payload: dict, expect: int = 202) -> dict:
        """POST ``payload``; logs the milliseconds to the response and fails
        unless its status is ``expect``."""
        import urllib.request

        req = urllib.request.Request(self.base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body = r.status, json.loads(r.read())
        log(f"[serve] POST {path}: {status} in {(time.perf_counter() - t0) * 1e3:.2f} ms")
        if status != expect:
            raise AssertionError(f"POST {path} answered {status}, not {expect}: {body}")
        return body

    def wait(self, job_id: str, timeout: float = 300.0) -> dict:
        """The job once it has ended, with its result and log; fails unless
        it is done."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            d = json.loads(self.get(f"/api/jobs/{job_id}?result=1&log=1")[1])
            if d["status"] not in ("pending", "running"):
                log(f"[serve] job {d['kind']} {d['status']}: "
                    f"{d['finished'] - (d['started'] or d['finished']):.3f} s of work")
                if d["status"] != "done":
                    raise AssertionError(f"job {d['kind']} ended {d['status']}: {d['error']}")
                return d
            time.sleep(0.05)
        raise AssertionError(f"job {job_id} did not end in {timeout} s")

    def stream(self, job_id: str) -> list[str]:
        """The job's SSE console, read to its ``[done]`` event."""
        import urllib.request

        lines = []
        with urllib.request.urlopen(f"{self.base}/api/jobs/{job_id}/stream", timeout=300) as r:
            if "text/event-stream" not in r.headers.get("Content-Type", ""):
                raise AssertionError("the stream route is not an event stream")
            for raw in r:
                line = raw.decode().rstrip("\n")
                if line.startswith("data: "):
                    lines.append(line[len("data: "):])
                    if lines[-1] == "[done]":
                        return lines
        raise AssertionError(f"the stream of job {job_id} ended without [done]")

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def write_az_example(out_dir: str, records) -> None:
    """``records`` in the AZ example format that ``load_real_example`` reads:
    semicolon CSVs per modality and ``real_IR/<sample-id>.csv`` (for the
    records that have IR)."""
    os.makedirs(os.path.join(out_dir, "real_IR"), exist_ok=True)
    for key, attr in (("1H", "h1"), ("13C", "c13"), ("HSQC", "hsqc"), ("COSY", "cosy")):
        with open(os.path.join(out_dir, f"real_{key}_with_AZ_SMILES_v3.csv"), "w") as f:
            f.write("sample-id;shifts;SN_Number;AZ_Number;SMILES\n")
            for i, r in enumerate(records):
                shifts = [[float(v) for v in p] for p in getattr(r, attr)] if key != "13C" \
                    else [float(v) for v in r.c13]
                f.write(f"{r.sample_id};{shifts};SN{i};AZ{i};{r.smiles}\n")
    for r in (r for r in records if r.ir is not None):
        with open(os.path.join(out_dir, "real_IR", f"{r.sample_id}.csv"), "w") as f:
            f.write("wavelength,spectra\n")
            f.writelines(f"{400 + 2 * i},{float(v)}\n" for i, v in enumerate(r.ir))


def serve_phase(dev, card: str) -> None:
    """Phase 7 (see the module docstring)."""
    import tempfile
    import urllib.parse

    import torch

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import beam_attention as k3
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.serve import ServerState, make_app
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig

    t_phase = time.perf_counter()
    counters = {"K1": k1, "K2": k2, "K3": k3}
    for m in counters.values():
        m.reset_launches()
    direct_launches = dict.fromkeys(counters, 0)  # the direct call's, not the server's
    state = ServerState(ModelConfig(), device=dev)
    http = _Http(make_app(state))
    try:
        job = http.post("/api/model", {"checkpoint": PHASE3})["job"]
        http.wait(job["job_id"])

        # 2) simulate, then every read-only route on the simulated records
        smiles = molrandom.random_corpus(16, seed=123)[:8]
        http.wait(http.post("/api/simulate", {"smiles": smiles})["job_id"])
        recs = json.loads(http.get("/api/records?source=sim")[1])
        if len(recs) != len(smiles):
            raise AssertionError(f"/api/records lists {len(recs)} simulated records, not 8")
        svgs = [f"/api/plot?source=sim&sample_id={recs[0]['sample_id']}&modality={m}"
                for m in recs[0]["modalities"]]
        svgs += [f"/api/molecule.svg?smiles={urllib.parse.quote(smiles[0])}",
                 f"/api/grid.svg?smiles={urllib.parse.quote(','.join(smiles))}"]
        for path in svgs:
            ctype, body = http.get(path)
            if "svg" not in ctype or not body.startswith(b"<svg"):
                raise AssertionError(f"GET {path} returned no SVG")
        log(f"[serve] {len(recs)} records listed; {len(svgs)} SVG routes answered "
            f"({', '.join(recs[0]['modalities'])} plots, a molecule, a grid)")

        # 3) the evaluate route against a direct call on the same records and model
        opts = dict(max_len=64, fanout=128, multinom_runs=10, max_temp_rounds=5,
                    compute_dtype="bfloat16")
        job = http.post("/api/evaluate", {**opts, "source": "sim", "simulate_errors": True})
        console = http.stream(job["job_id"])
        served = http.wait(job["job_id"])
        with state.lock:
            records = list(state.sim_records.values())
        phase3, _ = state.snapshot_model()
        before = {name: m.launches for name, m in counters.items()}
        t0 = time.perf_counter()
        results, summary = harness.evaluate_molecules(records, phase3, DecodeConfig(**opts),
                                                      simulate_errors=True, device=dev)
        direct_s = time.perf_counter() - t0
        for name, m in counters.items():
            direct_launches[name] += m.launches - before[name]
        mols = served["result"]["molecules"]
        served_s = served["finished"] - served["started"]
        worst = max(abs(m["corr_sampling_prob"] - r.corr_sampling_prob) for m, r in zip(mols, results))
        same = [m["target"] == r.target and m["greedy"] == r.greedy for m, r in zip(mols, results)]
        log(f"[serve] evaluate: {len(console) - 1} console lines streamed to [done]; {len(mols)} "
            f"molecules in {served_s:.3f} s through the server ({len(mols) / served_s:.3f} mols/s) "
            f"against {direct_s:.3f} s by a direct call ({len(results) / direct_s:.3f} mols/s); "
            f"greedy equal for {sum(same)} of {len(same)}, corr_sampling_prob within {worst:.2e} "
            f"(tol 1e-5), candidates {[m['n_candidates'] for m in mols]}")
        if len(mols) != len(results) or not all(same) or not worst <= 1e-5:
            raise AssertionError("the evaluate route disagrees with a direct evaluate_molecules call")
        if min(m["n_candidates"] for m in mols) <= 0:
            raise AssertionError("a molecule of the evaluate route has no candidates")

        # 4) beam hypotheses in the pools: K3 through the server
        k3_before = k3.launches
        job = http.post("/api/evaluate", {**opts, "source": "sim", "simulate_errors": True,
                                          "beam_candidates": 5})
        http.wait(job["job_id"])
        log(f"[serve] evaluate with beam_candidates 5: {k3.launches - k3_before} K3 launches")

        # 5) experimental spectra in the AZ format, through the real-data blend
        with tempfile.TemporaryDirectory() as tmp:
            write_az_example(tmp, records[:5])
            job = http.post("/api/run_exp_data", {**opts, "dir": tmp, "use_real_data": True})
            exp = http.wait(job["job_id"])["result"]["molecules"]
        ranked = [len(m["top_ranked"]) for m in exp]
        log(f"[serve] run_exp_data on 5 AZ-format records: top_ranked lengths {ranked}")
        if len(exp) != 5 or any("top_ranked" not in m for m in exp):
            raise AssertionError("run_exp_data did not rank 5 molecules")

        # 6) one improvement cycle, and the server's model swapped
        job = http.post("/api/improve", {"max_cycles": 1, "steps_per_cycle": 5})
        cycle = http.wait(job["job_id"])["result"]["cycles"][0]
        improved, _ = state.snapshot_model()
        moved = max((a - b).abs().max().item() for a, b in
                    zip(improved.state_dict().values(), phase3.state_dict().values()))
        stages = " ".join(f"{k}={v:.3f}" for k, v in cycle["stage_seconds"].items())
        log(f"[serve] improve: n_augmented {cycle['n_augmented']}, train_loss "
            f"{cycle['train_loss']:.4f}, stage seconds {stages}; the served model moved by up "
            f"to {moved:.3e} from phase3")
        if not (cycle["n_augmented"] > 0 and np.isfinite(cycle["train_loss"])) or \
                improved is phase3 or not moved > 0:
            raise AssertionError("the improve job did not fine-tune and swap the served model")

        # 7) the new model serves; one worker runs jobs in turn; a pending job cancels
        first = http.post("/api/evaluate", {**opts, "source": "sim", "simulate_errors": True})
        second = http.post("/api/evaluate", {"source": "sim", "max_len": 64, "run_mns": False})
        third = http.post("/api/evaluate", {"source": "sim", "max_len": 64, "run_mns": False})
        http.post(f"/api/jobs/{third['job_id']}/cancel", {}, expect=200)
        first, second = http.wait(first["job_id"]), http.wait(second["job_id"])
        third = json.loads(http.get(f"/api/jobs/{third['job_id']}")[1])
        after = first["result"]["summary"]["corr_sampling_prob"]
        log(f"[serve] after the cycle: corr_sampling_prob {after:.6f} (phase3 "
            f"{served['result']['summary']['corr_sampling_prob']:.6f}); the second job started "
            f"{second['started'] - first['finished']:.3f} s after the first ended; the cancelled "
            f"job is {third['status']}, started {third['started']}")
        if after == served["result"]["summary"]["corr_sampling_prob"]:
            raise AssertionError("the evaluate route still serves phase3 after the improve job")
        if second["started"] < first["finished"] or third["status"] != "cancelled" or \
                third["started"] is not None:
            raise AssertionError("the job queue did not run jobs in turn or cancel a pending one")
    finally:
        http.close()
        state.jobs.shutdown()

    launches = {name: m.launches - direct_launches[name] for name, m in counters.items()}
    log(f"[serve] launches through the server: K1={launches['K1']} K2={launches['K2']} "
        f"K3={launches['K3']}; the phase took {time.perf_counter() - t_phase:.1f} s; {card}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the server launched kernel {name} no time")


# ---------------------------------------------------------------------------
# phase 8: the contrastive trainers
# ---------------------------------------------------------------------------

def pinned_heldout_records(n: int = 982) -> list:
    """The accuracy report's pinned held-out records (``HELDOUT_RECORDS``
    filtered to the molecules of ``HELDOUT_DIR``), read with the report's
    own loaders."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location("torch_accuracy_report",
                                                  os.path.join("scripts", "torch_accuracy_report.py"))
    acc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(acc)
    keep = set(acc.load_heldout(HELDOUT_DIR, n))
    with tempfile.TemporaryDirectory() as scratch:
        records = acc.load_records(HELDOUT_RECORDS, scratch)
    return [r for r in records if r.smiles in keep][:n]


def tower_batches(dev, mmt_cfg, records, ccfg, n: int):
    """``n`` batches of the trainer's device path (weight-sorted rows of the
    device dataset, the corpus's text tokenized once): [(inputs, tokens,
    mask)]."""
    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.train import contrastive as con

    loader = dp.Loader(con._drop_truncating_records(records, mmt_cfg.model), mmt_cfg.model,
                       ccfg.batch_size, order_strategy=ccfg.order_strategy)
    dd = loader.device_dataset(dev)
    tk, mk = (torch.from_numpy(x).to(dev)
              for x in con.clip_tokenize(loader._device_kept_smiles, ccfg.max_text_len))
    rows, epoch = [], 0
    while len(rows) < n:
        rows += list(loader.epoch_row_batches(epoch))
        epoch += 1
    out = []
    for idx in rows[:n]:
        ia = torch.from_numpy(idx).to(dev).long()
        out.append((dp.gather_rows(dd, ia).inputs, tk[ia], mk[ia]))
    return out


def time_tower_steps(dev, tower, model, mmt_model, batches, ccfg, warmup: int) -> dict:
    """The trainer's step on ``batches`` (frozen bf16 encode, the tower's loss
    with dropout, backward, AdamW), host clock to the loss read back: the
    median after ``warmup`` steps, samples/s, peak memory, FLOPs of the
    encode and of the tower step (FlopCounterMode, one more step)."""
    import torch

    from multimodalspectraltransformer_torch.train import contrastive as con
    from multimodalspectraltransformer_torch.train.step import step_generator
    from multimodalspectraltransformer_torch.utils.roofline import flop_count

    opt = con.make_optimizer(con.trained_parameters(model, tower), ccfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, (inputs, toks, mask) in enumerate(batches):
        t0 = time.perf_counter()
        enc = con._encode_frozen(mmt_model, inputs)
        losses.append(float(con.tower_step(model, opt, tower, enc, toks, mask, ccfg.temperature,
                                           step_generator(0, i))))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    inputs, toks, mask = batches[0]
    enc = con._encode_frozen(mmt_model, inputs)
    enc_flops = flop_count(con._encode_frozen, mmt_model, inputs)
    tower_flops = flop_count(con.tower_step, model, opt, tower, enc, toks, mask, ccfg.temperature,
                             step_generator(0, 99))
    ms = float(np.median(times[warmup:])) * 1e3
    return dict(step_ms=ms, samples_per_s=ccfg.batch_size / ms * 1e3, peak_bytes=peak,
                enc_flops=enc_flops, tower_flops=tower_flops,
                tflops_per_s=(enc_flops + tower_flops) / ms * 1e-9, losses=losses,
                times_ms=[t * 1e3 for t in times])


def tower_step_card_vs_cpu(dev, tower, model, enc, toks, mask, lr: float, label: str) -> None:
    """One tower step from ``model`` (its copies on the CPU and the card),
    dropout off, on the same float32 encodings: ``compare_steps``."""
    import copy

    from multimodalspectraltransformer_torch.train import contrastive as con

    ccfg = con.ContrastiveConfig(learning_rate=lr)
    out = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        m = copy.deepcopy(model).to(d)
        opt = con.make_optimizer(con.trained_parameters(m, tower), ccfg)
        loss = con.tower_step(m, opt, tower, tuple(x.to(d) for x in enc), toks.to(d),
                              mask.to(d), 1.0)
        out[name] = (float(loss), {k: p.grad.cpu() for k, p in m.named_parameters()
                                   if p.grad is not None},
                     {k: v.cpu() for k, v in con.tower_state_dict(m, tower).items()})
    compare_steps(label, out, lr)


def tower_resume_exact(dev, tower, model, mmt_model, batches, ccfg) -> None:
    """Two steps, ``save_snapshot``, a third; a copy of the starting tower
    restored with ``load_snapshot`` equals the live one bit for bit, and
    takes the same third step (dropout on) to the same bits."""
    import copy
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.train import contrastive as con
    from multimodalspectraltransformer_torch.train.step import step_generator

    def step(m, opt, i):
        inputs, toks, mask = batches[i]
        return con.tower_step(m, opt, tower, con._encode_frozen(mmt_model, inputs), toks, mask,
                              ccfg.temperature, step_generator(0, i))

    live = copy.deepcopy(model)
    opt = con.make_optimizer(con.trained_parameters(live, tower), ccfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{tower}.msgpack.state")
        for i in range(2):
            step(live, opt, i)
        con.save_snapshot(path, live, tower, opt, 2)
        fresh = copy.deepcopy(model)
        opt2 = con.make_optimizer(con.trained_parameters(fresh, tower), ccfg)
        at = con.load_snapshot(path, fresh, tower, opt2)
    equal = lambda: all(torch.equal(a, b) for a, b in zip(live.state_dict().values(),
                                                           fresh.state_dict().values()))
    restored = at == 2 and equal()
    l_live, l_fresh = step(live, opt, 2), step(fresh, opt2, 2)
    ok = restored and equal() and torch.equal(l_live, l_fresh)
    log(f"[contrastive] {tower} resume: the .state snapshot restored at step {at} "
        f"{'bit-exact' if restored else 'DIFFERS'}; the next step from it "
        f"{'bit-exact' if ok else 'DIFFERS'} (loss {float(l_live):.6f})")
    if not ok:
        raise AssertionError(f"resuming the {tower} trainer from its snapshot is not exact")


def clip_r4_step_card_vs_cpu(dev, mmt_cfg, mmt_model, pinned, ccfg, batch_size: int = 64,
                             min_loss: float = 1e-2) -> None:
    """One clip tower step from clip_r4 (dropout and TF32 off) on the card
    and on the CPU: ``compare_steps``, on the first batch of the pinned
    held-out records whose loss is at least ``min_loss``. On factory records,
    clip_r4's own kind, a batch's loss is about 1e-4 and its gradient float32
    rounding noise."""
    import torch

    from multimodalspectraltransformer_torch.rank import clip
    from multimodalspectraltransformer_torch.train import contrastive as con

    r4 = clip.load_bundle(CLIP_R4, device=dev)[0].eval()
    bcfg = dataclasses.replace(ccfg, batch_size=batch_size)
    losses = []
    for inputs, toks, mask in tower_batches(dev, mmt_cfg, pinned, bcfg, len(pinned) // batch_size):
        enc = con._encode_frozen(mmt_model, inputs)
        with torch.no_grad():
            losses.append(float(con.tower_loss(r4, "clip", enc, toks, mask, 1.0)))
        if losses[-1] >= min_loss:
            break
    log(f"[contrastive] clip_r4's loss on batches of {batch_size} pinned held-out records: "
        + ", ".join(f"{x:.3e}" for x in losses))
    if losses[-1] < min_loss:
        raise AssertionError(f"no batch of the pinned held-out records has a loss of {min_loss}")
    tower_step_card_vs_cpu(dev, "clip", r4.cpu(), enc, toks, mask, ccfg.learning_rate,
                           f"[contrastive] check, one clip tower step from clip_r4 on "
                           f"{batch_size} pinned held-out records (loss {losses[-1]:.3e}, dropout "
                           f"and TF32 off)")


def contrastive_phase(dev, card: str, phase6_records, main) -> None:
    """Phase 8 (see the module docstring)."""
    import copy
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models import convert
    from multimodalspectraltransformer_torch.rank import clip, qformer
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.train import contrastive as con
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig

    t_phase = time.perf_counter()
    more = factory.simulate_records(molrandom.random_corpus(384, seed=3134),
                                    sample_ids=[f"g{i}" for i in range(384)], device=dev)
    recs = list(phase6_records) + more
    heldout, train = recs[:64], recs[64:]
    mmt_cfg = MMTConfig(model=ModelConfig())
    phase3 = convert.from_jax_params(convert.read_msgpack(PHASE3))
    mmt_model = con._encode_model(mmt_cfg.model, phase3, dev)
    r4, r4_cfg = clip.load_bundle(CLIP_R4, device=dev)
    ccfg = con.ContrastiveConfig(learning_rate=1e-4, weight_decay=1e-3, batch_size=256,
                                 max_text_len=64, order_strategy="weight_sorted", max_steps=6,
                                 save_every=3, log_every=1)
    log(f"[contrastive] set-up: {len(more)} more factory molecules simulated, {len(train)} "
        f"training and {len(heldout)} held-out records, clip_r4 ({r4_cfg.text_layers} layers, "
        f"{r4_cfg.text_hidden} wide, dropout {r4_cfg.dropout}, "
        f"{sum(p.numel() for p in r4.parameters()) / 1e6:.1f} M parameters) in "
        f"{time.perf_counter() - t_phase:.2f} s")
    pinned = pinned_heldout_records()
    recall = lambda m, recs=heldout: con.retrieval_accuracy(m, mmt_cfg, phase3, recs, "clip",
                                                            batch_size=64, device=dev)
    fmt = lambda r: " ".join(f"{k}={v:.4f}" for k, v in r.items() if k != "n")
    before, before_pinned = recall(r4), recall(r4, pinned)

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "clip.msgpack")
        t0 = time.perf_counter()
        model, logger = con.train_contrastive(mmt_cfg, phase3, train, "clip", ccfg,
                                              tower_cfg=r4_cfg, init_variables=r4.state_dict(),
                                              checkpoint_path=ck, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [x["clip_loss"] for x in logger.history]
        files = sorted(os.listdir(tmp))
        after, after_pinned = recall(model), recall(model, pinned)
        log(f"[contrastive] train_contrastive clip from clip_r4, batch 256: {len(losses)} steps "
            f"in {wall:.2f} s (set-up included), losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; wrote {files}")
        log(f"[contrastive] retrieval on {before['n']} held-out factory records: before "
            f"{fmt(before)}; after {fmt(after)}")
        log(f"[contrastive] retrieval on the {before_pinned['n']} pinned held-out records of the "
            f"accuracy report: before {fmt(before_pinned)}; after {fmt(after_pinned)}")
        if len(losses) != 6 or not np.all(np.isfinite(losses)) or files != [
                "clip.msgpack", "clip.msgpack.state"]:
            raise AssertionError("train_contrastive did not take 6 finite steps with its snapshot "
                                 "and export")
        bundle_path = os.path.join(tmp, "bundle.msgpack")
        clip.save_bundle(bundle_path, model, r4_cfg)
        bundle = clip.load_bundle(bundle_path, device=dev)
    records, main_model, dcfg = main
    results, summary = harness.evaluate_molecules(records, main_model, dcfg, seed=0,
                                                  clip_bundle=bundle,
                                                  clip_block=dcfg.multinom_runs, device=dev)
    scores = [c.clip_loss for r in results for c in r.candidates]
    log(f"[check] the saved bundle through evaluate_molecules: {len(scores)} candidates of "
        f"{summary.n} molecules scored, every CLIP loss finite: {bool(np.isfinite(scores).all())}")
    if not scores or not np.isfinite(scores).all():
        raise AssertionError("the trained bundle did not score the candidates")

    batches = tower_batches(dev, mmt_cfg, train, ccfg, 11)
    r = time_tower_steps(dev, "clip", model, mmt_model, batches, ccfg, warmup=3)
    log(f"[contrastive] clip step at batch 256 (bf16 frozen encode, fp32 tower, TF32 off): median "
        f"{r['step_ms']:.3f} ms after 3 warm-up steps (steps {', '.join(f'{t:.1f}' for t in r['times_ms'])} "
        f"ms), {r['samples_per_s']:.1f} samples/s, {(r['enc_flops'] + r['tower_flops']) / 1e12:.4f} "
        f"TFLOP a step (encode {r['enc_flops'] / 1e12:.4f}, tower {r['tower_flops'] / 1e12:.4f}), "
        f"{r['tflops_per_s']:.2f} TFLOP/s ({r['tflops_per_s'] * 1e12 / F32_FLOPS:.1%} of the "
        f"float32 peak), peak memory {r['peak_bytes'] / 2**30:.3f} GiB; {card}")
    tower_resume_exact(dev, "clip", model, mmt_model, batches, ccfg)
    del model, r4
    clip_r4_step_card_vs_cpu(dev, mmt_cfg, mmt_model, pinned, ccfg)

    # the BLIP trainer at QFormerConfig() width, batch 32 (the cli's default)
    bcfg = dataclasses.replace(ccfg, batch_size=32, max_steps=4, save_every=0)
    t0 = time.perf_counter()
    blip, logger = con.train_contrastive(mmt_cfg, phase3, train, "blip", bcfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [x["blip_loss"] for x in logger.history]
    n_params = sum(p.numel() for p in con.trained_parameters(blip, "blip"))
    r = time_tower_steps(dev, "blip", blip, mmt_model,
                         tower_batches(dev, mmt_cfg, train, bcfg, 7), bcfg, warmup=2)
    log(f"[contrastive] train_contrastive blip (QFormerConfig(): 12 layers, 768 wide, "
        f"{n_params / 1e6:.1f} M trained parameters), batch 32: {len(losses)} steps in "
        f"{wall:.2f} s (init included), losses {', '.join(f'{x:.4f}' for x in losses)}; step "
        f"median {r['step_ms']:.3f} ms after 2 warm-up steps, {r['samples_per_s']:.1f} samples/s, "
        f"{(r['enc_flops'] + r['tower_flops']) / 1e12:.4f} TFLOP a step, "
        f"{r['tflops_per_s']:.2f} TFLOP/s, peak memory {r['peak_bytes'] / 2**30:.3f} GiB; {card}")
    if len(losses) != 4 or not np.all(np.isfinite(losses + r["losses"])):
        raise AssertionError("the BLIP trainer's losses are not finite")
    inputs, _, _ = tower_batches(dev, mmt_cfg, heldout, dataclasses.replace(bcfg, batch_size=8),
                                 1)[0]
    _, memory, kpm = con._encode_frozen(mmt_model, inputs)
    blip.eval()
    t0 = time.perf_counter()
    g_card = qformer.lm_generate_greedy(blip, memory, kpm, 64)
    torch.cuda.synchronize()
    s_card = time.perf_counter() - t0
    g_cpu = qformer.lm_generate_greedy(copy.deepcopy(blip).cpu(), memory.cpu(), kpm.cpu(), 64)
    same = torch.equal(g_card.cpu(), g_cpu)
    log(f"[check] lm_generate_greedy of 8 molecules x 64 steps at QFormerConfig() width, card "
        f"({s_card:.2f} s) vs CPU: tokens {'identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("lm_generate_greedy on the card differs from the CPU")
    log(f"[contrastive] the phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the simulators' trainer and the offline tools
# ---------------------------------------------------------------------------

# JAX's train_shift_model / train_ir_model(data, n_steps=1, lr=0.0) from the
# committed weights on build_teacher_dataset(random_corpus(4096, seed=11)),
# seed 0, on a CPU: the held-out MAEs of the committed weights on that split
SHIFT_ANCHOR = {"val_mae_c_ppm": 0.55575, "val_mae_h_ppm": 0.017206}
IR_ANCHOR = {"val_mae": 0.017412}


def sha256_files(d: str) -> dict:
    import hashlib

    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def distill_anchors(dev, data) -> None:
    """The committed weights, trained one step at lr 0 on the card, report
    the JAX package's held-out MAEs within 1e-3 relative."""
    from multimodalspectraltransformer_torch.sim import distill

    shift, _ = distill.load_shift_weights(device=dev)
    with open(os.path.join(distill.WEIGHTS_DIR, "nmr_shift.json")) as f:
        stats = json.load(f)["stats"]
    _, _, rep = distill.train_shift_model(data, n_steps=1, lr=0.0, init_params=shift.state_dict(),
                                          init_stats=stats, device=dev)
    ir = distill.load_ir_weights(device=dev)
    _, ir_rep = distill.train_ir_model(data, n_steps=1, lr=0.0, init_params=ir.state_dict(),
                                       device=dev)
    got = {**{k: rep[k] for k in SHIFT_ANCHOR}, **{k: ir_rep[k] for k in IR_ANCHOR}}
    want = {**SHIFT_ANCHOR, **IR_ANCHOR}
    ok = all(abs(got[k] - v) <= 1e-3 * v for k, v in want.items())
    log("[tools] committed simulator weights on the card, one step at lr 0: "
        + ", ".join(f"{k} {got[k]:.6f} (JAX {v})" for k, v in want.items())
        + f" (tol 1e-3 relative) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the committed simulator weights do not give JAX's held-out MAEs")


def _train_recording(train, **kw):
    """``train(**kw)`` -> (its result, each step's gradients on the CPU, in
    ``named_parameters`` order)."""
    from multimodalspectraltransformer_torch.sim import distill

    grads = []
    step = distill.OptaxAdamW.step

    def recording(opt, lr):
        grads.append([p.grad.detach().cpu().clone() for p in opt.params])
        step(opt, lr)

    distill.OptaxAdamW.step = recording
    try:
        return train(**kw), grads
    finally:
        distill.OptaxAdamW.step = step


def distill_card_vs_cpu(dev, data) -> None:
    """3 steps of each trainer from the same fresh init (seed 0) at batch 256
    (shift) and 128 (IR), on the card and on the CPU: the final loss within
    1e-5 relative; every parameter within 1e-5 of its leaf's largest
    magnitude wherever the gradient is resolved (``resolved_gradient``) at
    every step: Adam's later steps turn the rounding of a gradient that is
    not into a different update."""
    import functools

    import torch

    from multimodalspectraltransformer_torch.sim import distill

    for name, train, kw in (("shift", distill.train_shift_model, dict(batch_size=256)),
                            ("IR", distill.train_ir_model, dict(batch_size=128))):
        out = {}
        for d in ("cpu", dev):
            res, grads = _train_recording(train, data=data, n_steps=3, log_every=0, device=d, **kw)
            model, rep = res[0], res[-1]
            names = [k for k, _ in model.named_parameters()]
            out[str(d)] = (rep["final_loss"], [dict(zip(names, g)) for g in grads],
                           {k: p.detach().cpu() for k, p in model.named_parameters()})
        (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = out["cpu"], out[str(dev)]
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        worst, where = 0.0, ""
        n_unresolved = n_over = 0
        for k, p in p_cpu.items():
            resolved = functools.reduce(torch.logical_and, (resolved_gradient(a[k], b[k])
                                                           for a, b in zip(g_cpu, g_card)))
            n_unresolved += int((~resolved).sum())
            rel = (p_card[k] - p).abs() / p.abs().max()
            n_over += int((rel[resolved] > 1e-5).sum())
            if resolved.any() and rel[resolved].max().item() > worst:
                worst = rel[resolved].max().item()
                i = int((rel * resolved).argmax())
                where = (f" (at {k}[{i}]: gradients {[f'{g[k].flatten()[i].item():.3e}' for g in g_cpu]}"
                         f" on the CPU, {[f'{g[k].flatten()[i].item():.3e}' for g in g_card]} on "
                         f"the card)")
        n_all = sum(p.numel() for p in p_cpu.values())
        ok = loss_rel <= 1e-5 and worst <= 1e-5
        log(f"[tools] {name} trainer, 3 steps at batch {kw['batch_size']} from the seeded init, "
            f"card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}, tol 1e-5); "
            f"params within {worst:.2e} of their leaf's max where the gradient is resolved at "
            f"every step{where} (tol 1e-5; {n_over} over it; {n_unresolved} of {n_all} "
            f"unresolved) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the {name} trainer's steps on the card differ from the CPU")


def time_distill(dev, data, card: str) -> None:
    """200 steps of each trainer at batch 256 (shift) and 128 (IR): ms per
    step as the wall time of a 220-step run less that of a 20-step run
    (set-up and validation cancel), twice in turn; samples/s, peak memory,
    FLOPs a step (FlopCounterMode: a 2-step run less a 1-step run), TFLOP/s
    and the share of the float32 peak, and CUDA kernels a step under
    torch.profiler (a 20-step run less a 10-step run)."""
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.sim import distill
    from multimodalspectraltransformer_torch.utils import profiling, roofline

    def kernels(prof) -> int:
        return sum(1 for e in prof.events()
                   if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False))

    for name, train, batch in (("shift", distill.train_shift_model, 256),
                               ("IR", distill.train_ir_model, 128)):
        run = lambda n: train(data, batch_size=batch, n_steps=n, log_every=0, device=dev)
        run(20)  # warm-up
        walls = {20: [], 220: []}
        torch.cuda.reset_peak_memory_stats()
        for n in (20, 220, 220, 20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n)
            walls[n].append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        ms = [(b - a) / 200 * 1e3 for a, b in zip(walls[20], walls[220][::-1])]
        flops = roofline.flop_count(run, 2) - roofline.flop_count(run, 1)
        counts = {}
        with tempfile.TemporaryDirectory() as tmp:
            for n in (10, 20):
                with profiling.device_trace(os.path.join(tmp, str(n))) as prof:
                    run(n)
                    torch.cuda.synchronize()
                counts[n] = kernels(prof)
        rl = roofline.Roofline(name, float(np.mean(ms)) * 1e-3, flops, 0.0, "float32")
        log(f"[tools] {name} trainer, 200 steps at batch {batch} (hidden 128, 4 message steps"
            f"{', 1801 bins' if name == 'IR' else ''}): "
            f"{' / '.join(f'{x:.3f}' for x in ms)} ms a step, "
            f"{' / '.join(f'{batch / x * 1e3:.1f}' for x in ms)} samples/s, "
            f"{flops / 1e9:.3f} GFLOP a step, {rl.achieved_flops / 1e12:.3f} TFLOP/s "
            f"({rl.mfu:.2%} of the float32 peak), peak memory {peak / 2**30:.3f} GiB, "
            f"{(counts[20] - counts[10]) / 10:.1f} CUDA kernels a step; {card}")


def distill_files(dev, data) -> None:
    """``save_*_weights`` into a temporary directory; ``load_*_weights``
    read back the same parameters and stats."""
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.sim import distill

    shift, stats, rep = distill.train_shift_model(data, n_steps=2, log_every=0, device=dev)
    ir, ir_rep = distill.train_ir_model(data, n_steps=2, log_every=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        distill.save_shift_weights(shift, stats, rep, tmp)
        distill.save_ir_weights(ir, ir_rep, tmp)
        files = sorted(os.listdir(tmp))
        shift2, stats2 = distill.load_shift_weights(tmp, device=dev)
        ir2 = distill.load_ir_weights(tmp, device=dev)
    same = all(torch.equal(a, b) for m, m2 in ((shift, shift2), (ir, ir2))
               for a, b in zip(m.state_dict().values(), m2.state_dict().values()))
    same_stats = (stats2.mean_c, stats2.std_c, stats2.mean_h, stats2.std_h) == tuple(
        stats[k] for k in ("mean_c", "std_c", "mean_h", "std_h"))
    log(f"[tools] weight files {files} written and read back: parameters "
        f"{'equal' if same else 'DIFFER'}, stats {'equal' if same_stats else 'DIFFER'}")
    if not (same and same_stats):
        raise AssertionError("the saved simulator weights do not read back equal")


def model_db_checks(dev, records, model, card: str) -> np.ndarray:
    """``build_model_db`` with phase3 over ``records`` at batch 256 on the card,
    and over the first 64 on the CPU: the fingerprints within 1e-4 of their
    largest magnitude; every record whose SMILES is unique retrieves itself
    first by cosine; the card's top-10 indices equal the CPU's on the card's
    vectors. Returns the card's DB."""
    import collections
    import copy

    import torch

    from multimodalspectraltransformer_torch.eval import vectordb

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = vectordb.build_model_db(records, model, batch_size=256, device=dev)
    secs = time.perf_counter() - t0
    ref = vectordb.build_model_db(records[:64], copy.deepcopy(model).cpu(), device="cpu")
    fp_err = float(np.abs(db.vectors[:64] - ref.vectors).max() / np.abs(ref.vectors).max())
    s, idx, _ = vectordb.query(db, db.vectors, k=10, device=dev)
    s_cpu, idx_cpu, _ = vectordb.query(db, db.vectors, k=10, device="cpu")
    counts = collections.Counter(db.smiles)
    unique = [i for i, smi in enumerate(db.smiles) if counts[smi] == 1]
    self_first = sum(int(idx[i, 0] == i) for i in unique)
    ok = (db.smiles[:64] == ref.smiles and fp_err <= 1e-4 and self_first == len(unique)
          and np.array_equal(idx, idx_cpu))
    log(f"[tools] model DB of {len(db)} records (phase3 fingerprints, batch 256) in {secs:.2f} s "
        f"on the card: the first 64 within {fp_err:.2e} of the CPU's (tol 1e-4); {self_first} of "
        f"{len(unique)} records with a unique SMILES retrieve themselves first by cosine; top-10 "
        f"indices {'equal' if np.array_equal(idx, idx_cpu) else 'DIFFER'} card vs CPU, scores "
        f"within {np.abs(s - s_cpu).max():.2e} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("the model vector DB fails its checks")
    return db


def morgan_db_checks(dev, card: str) -> list:
    """A 512-bit Morgan DB of ``random_corpus(10000, seed=12)``; 256 of its
    SMILES queried at k 10 on the card and on the CPU: each first hit scores
    1.0, scores and indices equal; queries per second on the card. Returns
    the corpus."""
    import torch

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.eval import vectordb

    corpus = molrandom.random_corpus(10000, seed=12)
    db = vectordb.build_morgan_db(corpus, n_bits=512)
    queries = db.smiles[:256]
    vectordb.query_smiles(db, queries, k=10, device=dev)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, idx, _, valid = vectordb.query_smiles(db, queries, k=10, device=dev)
        times.append(time.perf_counter() - t0)
    s_cpu, idx_cpu, _, _ = vectordb.query_smiles(db, queries, k=10, device="cpu")
    ok = (valid.all() and (s[:, 0] == 1.0).all() and np.array_equal(s, s_cpu)
          and np.array_equal(idx, idx_cpu))
    log(f"[tools] Morgan DB of {len(db)} molecules (512 bits): 256 queries at k 10 in "
        f"{' / '.join(f'{t * 1e3:.2f}' for t in times)} ms on the card "
        f"({len(queries) / min(times):.0f} queries/s, fingerprints included); every first hit "
        f"scores 1.0: {bool((s[:, 0] == 1.0).all())}; scores and indices equal to the CPU's: "
        f"{np.array_equal(s, s_cpu) and np.array_equal(idx, idx_cpu)} {'ok' if ok else 'FAIL'}; "
        f"{card}")
    if not ok:
        raise AssertionError("the Morgan vector DB fails its checks")
    return corpus


def layout_checks(db) -> None:
    """UMAP of the model DB's vectors and the standalone HTML plot (numpy
    and scipy only: the card's machine has no sklearn or matplotlib)."""
    import tempfile

    from multimodalspectraltransformer_torch.eval import clustering, umap

    t0 = time.perf_counter()
    coords = umap.umap_embed(db.vectors)
    with tempfile.TemporaryDirectory() as tmp:
        path = clustering.cluster_plot_html(coords, db.smiles, os.path.join(tmp, "c.html"),
                                            clustering.mw_labels(db.smiles))
        size = os.path.getsize(path)
    ok = coords.shape == (len(db), 2) and bool(np.isfinite(coords).all()) and size > 1000
    log(f"[tools] umap_embed of {db.vectors.shape} and cluster_plot_html in "
        f"{time.perf_counter() - t0:.2f} s: finite layout {coords.shape}, {size} bytes of HTML "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the UMAP layout or its plot failed")


def cli_vectorize_check(corpus) -> None:
    """``python -m multimodalspectraltransformer_torch.cli vectorize`` in a
    subprocess exits 0 and prints its two JSON lines."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        smi = os.path.join(tmp, "mols.txt")
        with open(smi, "w") as f:
            f.write("\n".join(corpus[:500]) + "\n")
        out = os.path.join(tmp, "db")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "multimodalspectraltransformer_torch.cli",
                               "vectorize", "--smiles", smi, "--out", out, "--csv", "--query",
                               corpus[3]], capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
        files = sorted(os.listdir(tmp))
    ok = (proc.returncode == 0 and len(lines) == 2 and lines[0]["n"] == 500
          and lines[1]["scores"][0] == 1.0 and files == ["db.csv", "db.json", "db.npz", "mols.txt"])
    log(f"[tools] cli vectorize (500 molecules, --csv, --query) in {secs:.2f} s: exit "
        f"{proc.returncode}, {lines[0] if lines else proc.stderr[-500:]}, first hit "
        f"{lines[1]['hits'][0] if len(lines) > 1 else None} at "
        f"{lines[1]['scores'][0] if len(lines) > 1 else None}; wrote {files} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli vectorize failed")


def torch_checkpoint_check(dev, main) -> None:
    """phase3 exported with ``to_torch_state_dict`` as a Lightning-style
    ``.ckpt``, read back by ``load_torch_checkpoint`` into a model on the
    card: its float32 greedy decodes of phase 3's molecules equal phase3's,
    token for token."""
    import tempfile

    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.decode import samplers
    from multimodalspectraltransformer_torch.models import convert, mmt
    from multimodalspectraltransformer_torch.models.mmt import MMTBatch

    records, model, dcfg = main
    cfg = model.cfg
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase3.ckpt")
        sd = convert.to_torch_state_dict(cfg, model.state_dict())
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, path)
        other = mmt.model_from_state_dict(convert.load_torch_checkpoint(cfg, path), cfg, dev)

    def greedy(m):
        feats = [f for f in (dp.featurize(r, cfg) for r in records) if f is not None]
        with torch.no_grad():
            enc = m.encode(MMTBatch(*dp.collate(feats).inputs).to(dev))
        return samplers.greedy_decode(m.state_dict(), cfg, enc.memory, enc.memory_key_padding_mask,
                                      1.0, dcfg.max_len, device=dev).tokens.cpu()

    a, b = greedy(model), greedy(other)
    same = torch.equal(a, b)
    log(f"[tools] phase3 through a Lightning-style .ckpt ({len(sd)} tensors, MF table "
        f"{tuple(sd[convert.MF_KEY].shape)}): greedy decodes of {a.shape[0]} molecules x "
        f"{a.shape[1]} tokens {'identical' if same else 'DIFFER'} to phase3's")
    if not same:
        raise AssertionError("the model read from the torch checkpoint decodes otherwise")


def tools_phase(dev, card: str, phase6_records, main) -> None:
    """Phase 9 (see the module docstring)."""
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import distill
    from multimodalspectraltransformer_torch.utils.profiling import PhaseTimer

    t_phase = time.perf_counter()
    sums = sha256_files(distill.WEIGHTS_DIR)
    timer = PhaseTimer()
    with timer.phase("teacher dataset"):
        data = distill.build_teacher_dataset(molrandom.random_corpus(4096, seed=11))
    log(f"[tools] teacher dataset: {len(data['n_atoms'])} graphs of random_corpus(4096, seed=11) "
        f"in {timer.totals['teacher dataset']:.2f} s")
    with timer.phase("distill anchors"):
        distill_anchors(dev, data)
    with timer.phase("distill card vs cpu"):
        distill_card_vs_cpu(dev, data)
    with timer.phase("distill timed"):
        time_distill(dev, data, card)
    with timer.phase("weight files"):
        distill_files(dev, data)
    with timer.phase("model db"):
        db = model_db_checks(dev, phase6_records, main[1], card)
    with timer.phase("morgan db"):
        corpus = morgan_db_checks(dev, card)
    with timer.phase("umap and html"):
        layout_checks(db)
    with timer.phase("cli vectorize"):
        cli_vectorize_check(corpus)
    with timer.phase("torch checkpoint"):
        torch_checkpoint_check(dev, main)
    after = sha256_files(distill.WEIGHTS_DIR)
    log(f"[tools] sha256 of the committed simulator weights ({', '.join(sums)}) "
        f"{'unchanged' if after == sums else 'CHANGED'}")
    if after != sums:
        raise AssertionError(f"the phase changed {distill.WEIGHTS_DIR}")
    log("[tools] stages:\n" + timer.report())
    log(f"[tools] the phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: data and tensor parallelism
# ---------------------------------------------------------------------------

# the parallel steps: phase3 with dropout on, lr 3e-5: fp32 (TF32 off) for
# data parallelism; float64 compute for tensor parallelism, whose partial sums
# of the row-parallel layers add in another order, so that in fp32 a
# feed-forward input within rounding of 0 can take the other side of ReLU's
# kink and move its gradient by a whole term (float64 leaves no input that
# near); phase 6's bf16 recipe for the timings. The bounds are
# tests/test_multislice.py's.
PAR_LOSS_RTOL, PAR_GRAD_TOL = 2e-5, 5e-5
PAR_BATCH = 64


def _par_cfgs():
    """The fp32, float64 and bf16 step configurations."""
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig

    fp32 = MMTConfig(model=ModelConfig(), train=TrainConfig(learning_rate=3e-5))
    fp64 = MMTConfig(model=ModelConfig(dtype="float64"), train=TrainConfig(learning_rate=3e-5))
    bf16 = MMTConfig(model=ModelConfig(), train=TrainConfig(learning_rate=3e-5,
                                                            mixed_precision=True))
    return fp32, fp64, bf16


def _rank_device():
    """This rank's card (the launcher made it the current one), TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _sharded_start(cfg, batch, shard, dev):
    """Phase3 on ``dev`` put on ``shard`` (``parallel.shard_model``; as it is
    for None) and the shard's rows of ``batch`` there."""
    from multimodalspectraltransformer_torch import parallel
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import mmt

    model = mmt.load_model(PHASE3, cfg.model, device=dev)
    rows = slice(None)
    if shard is not None:
        parallel.shard_model(model, shard)
        rows = shard.rows(PAR_BATCH // shard.dp_size)
    b = dp.to_device(dp.TrainBatch(type(batch.inputs)(*(x[rows] for x in batch.inputs)),
                                   batch.trg_tokens[rows], batch.trg_fp[rows]), dev)
    return model, b


def _step_result(cfg, batch, shard, dev, seed: int = 5) -> dict:
    """One train step from phase3 on ``shard``'s rows (the whole batch for
    None): loss, and the whole gradients and updated parameters on the CPU."""
    import torch

    from multimodalspectraltransformer_torch import parallel
    from multimodalspectraltransformer_torch.parallel.mesh import gather_tp
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step

    model, b = _sharded_start(cfg, batch, shard, dev)
    state, m = step.train_step(cfg, st.create_state(cfg.train, model), b, seed)
    grads = {n: gather_tp(n, p.grad, shard).cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {k: v.cpu() for k, v in parallel.gather_state_dict(model).items()}
    del state, model
    torch.cuda.empty_cache()
    return dict(loss=float(m.loss), grads=grads, params=params)


def _median_step_ms(cfg, batch, shard, dev, warmup: int = 3, timed: int = 8) -> dict:
    """The median step time in ms (host clock around a step that ends in a
    device sync) of ``timed`` steps after ``warmup`` on ``shard``'s rows, and
    the peak memory; with more than one data-parallel rank also the median ms
    of the gradient all-reduce alone on this rank's gradients."""
    import torch

    from multimodalspectraltransformer_torch.parallel import collectives
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step

    model, b = _sharded_start(cfg, batch, shard, dev)
    state = st.create_state(cfg.train, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step.train_step(cfg, state, b, 5)
        float(m.loss)
        times.append((time.perf_counter() - t0) * 1e3)
    out = dict(step_ms=float(np.median(times[warmup:])), peak_bytes=torch.cuda.max_memory_allocated())
    if shard is not None and shard.data_group is not None and shard.dp_size > 1:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        ar = []
        for _ in range(warmup + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collectives.grad_all_reduce_(grads, shard)
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        out.update(all_reduce_ms=float(np.median(ar[warmup:])),
                   all_reduce_bytes=4 * sum(g.numel() for g in grads))
    del state, model
    torch.cuda.empty_cache()
    return out


def _harness_run(records, dcfg, dev, mesh=None, clip_bundle=None, warm: bool = False) -> dict:
    """``evaluate_molecules`` on phase 3's records with phase3 and clip_r4
    (``clip_block`` 10), seed 0, after a warm-up call when ``warm``; the K1
    and K2 launches of the last call."""
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.rank import clip

    model = mmt.load_model(PHASE3, device=dev)
    bundle = clip_bundle or clip.load_bundle(CLIP_R4, device=dev)
    run = dict(clip_bundle=bundle, clip_block=dcfg.multinom_runs, device=dev, mesh=mesh)
    if warm:
        harness.evaluate_molecules(records, model, dcfg, seed=1, **run)
    k1.reset_launches()
    k2.reset_launches()
    results, summary = harness.evaluate_molecules(records, model, dcfg, seed=0, **run)
    return dict(results=results, summary=summary, k1=k1.launches, k2=k2.launches)


def _rank_nccl_training(records) -> dict:
    """Check (a), in a world of one rank over NCCL: ``run_training`` for 5
    bf16 steps from phase3, without a mesh and with ``make_mesh()``; both
    runs' losses and parameters. Both runs use PyTorch's deterministic
    algorithms, as they did when the CUDA backward of ``F.embedding`` summed
    a token's rows in a varying order (7 of 40 runs on an H100 then differed
    from the first in ``embed_trg.weight``); the lookups' gradients now go
    through E1, and phase 14 holds run_training to itself under the default
    algorithms."""
    import torch

    from multimodalspectraltransformer_torch import parallel
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import convert
    from multimodalspectraltransformer_torch.train import loop

    dev = _rank_device()
    torch.use_deterministic_algorithms(True)
    _, _, bf16 = _par_cfgs()
    init = convert.from_jax_params(convert.read_msgpack(PHASE3))
    opts = dp.FeaturizeOptions(use_given_smiles_form=True)
    out = {}
    for name, mesh in (("plain", None), ("mesh", parallel.make_mesh())):
        loader = dp.Loader(records, bf16.model, batch_size=PAR_BATCH, opts=opts)
        t0 = time.perf_counter()
        res = loop.run_training(bf16, loader, init_params=init, mesh=mesh, max_steps=5, device=dev)
        out[name] = dict(losses=[h["train_loss"] for h in res.metrics.history],
                         params={k: v.cpu() for k, v in res.state.model.state_dict().items()},
                         secs=time.perf_counter() - t0,
                         backend=str(torch.distributed.get_backend()))
    return out


HOST_OPTS = dict(blank_percentage=0.2, randomize_smiles=True, hsqc_noise_max=3)


def _host_loader_ms(records, mcfg, part=None, n_batches: int = 2) -> float:
    """Host ms a batch of ``Loader.epoch`` (``part``: a rank's rows) under
    stochastic featurization, over the first ``n_batches`` of epoch 0."""
    from multimodalspectraltransformer_torch.data import pipeline as dp

    ldr = dp.Loader(records, mcfg, batch_size=PAR_BATCH, seed=1,
                    opts=dp.FeaturizeOptions(**HOST_OPTS))
    it = ldr.epoch(0, part)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        next(it)
    return (time.perf_counter() - t0) * 1e3 / n_batches


def _rank_parallel(batch, records8, records_ds) -> dict:
    """Checks (b)-(e) on one of two ranks sharing the card over gloo."""
    import dataclasses

    import torch

    from multimodalspectraltransformer_torch import parallel
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.rank import clip
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig

    dev = _rank_device()
    rank = torch.distributed.get_rank()
    fp32, fp64, bf16 = _par_cfgs()
    dp_mesh, tp_mesh = parallel.make_mesh(data=2), parallel.make_mesh(data=1, model=2)
    out = dict(rank=rank)
    # (b), (c): one fp32 DP and one float64 TP step; then the bf16 timings
    for name, mesh, cfg in (("dp", dp_mesh, fp32), ("tp", tp_mesh, fp64)):
        shard = parallel.rank_shard(mesh)
        step = _step_result(cfg, batch, shard, dev)
        out[name] = step if rank == 0 else dict(loss=step["loss"])
        out[name + "_timing"] = _median_step_ms(bf16, batch, shard, dev)
    # (d): the sharded harness, float32 then bf16 (timed, launches counted)
    bundle = clip.load_bundle(CLIP_R4, device=dev)
    dcfg = DecodeConfig(max_len=64, fanout=128, multinom_runs=10, max_temp_rounds=5,
                        compute_dtype="bfloat16", round_shrink=False)
    h32 = _harness_run(records8, dataclasses.replace(dcfg, compute_dtype=None), dev, dp_mesh,
                       bundle)
    h16 = _harness_run(records8, dcfg, dev, dp_mesh, bundle, warm=True)
    out["harness_fp32"] = dict(results=h32["results"], summary=h32["summary"])
    out["harness_bf16"] = dict(summary=h16["summary"], k1=h16["k1"], k2=h16["k2"])
    # the host loader under stochastic featurization: this rank's rows
    out["host_loader_ms"] = _host_loader_ms(records_ds, fp32.model, (rank, 2))
    # (e): the sharded device dataset
    ldr = dp.Loader(records_ds, fp32.model, batch_size=PAR_BATCH, seed=1)
    dd = ldr.device_dataset_sharded(dp_mesh, dev)
    shard = parallel.rank_shard(dp_mesh)
    rows = shard.rows(PAR_BATCH // 2)
    got = []
    for idx in ldr.epoch_row_batches_sharded(0, 2):
        b = dp.gather_rows(dd, idx[rows])
        got.append((idx, b.trg_tokens.cpu(), b.inputs.src_13c.cpu(), b.trg_fp.cpu()))
    out["dataset"] = dict(batches=got, kept=ldr._device_kept_smiles, index=shard.dp_index)
    return out


def _compare_parallel(label: str, ref: dict, got: dict, lr: float) -> None:
    """A parallel step (``got``) against one process (``ref``): the loss
    within 2e-5 relative, each gradient leaf within 5e-5 of its largest
    magnitude, the parameters after AdamW within 5e-5 of their leaf's largest
    magnitude wherever the gradient is resolved (``resolved_gradient``: AdamW
    turns an unresolved gradient's rounding into a step of either sign) and
    within 2 lr elsewhere, where under 20% of the elements may lie. Raises
    when they differ."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_errs = {k: ((got["grads"][k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                 for k, g in ref["grads"].items()}
    grad_err = max(grad_errs.values())
    worst_res = worst = 0.0
    n_all = n_unres = 0
    for k, p in ref["params"].items():
        g = ref["grads"].get(k)
        diff = (got["params"][k] - p).abs()
        worst = max(worst, diff.max().item())
        n_all += p.numel()
        if g is None:
            continue
        res = resolved_gradient(g, got["grads"][k])
        n_unres += int((~res).sum())
        if res.any():
            worst_res = max(worst_res, (diff[res].max() / p.abs().max().clamp_min(1e-30)).item())
    ok = (loss_rel <= PAR_LOSS_RTOL and grad_err <= PAR_GRAD_TOL and worst_res <= PAR_GRAD_TOL
          and worst <= 2 * lr and n_unres < 0.2 * n_all)
    leaf = max(grad_errs, key=grad_errs.get)
    log(f"{label}: loss {got['loss']:.6f} vs {ref['loss']:.6f} (rel {loss_rel:.2e}, tol 2e-5); "
        f"gradients within {grad_err:.2e} of their leaf's max (at {leaf}; tol 5e-5); parameters "
        f"within {worst_res:.2e} of their leaf's max where resolved (tol 5e-5), {worst:.2e} over "
        f"all (tol {2 * lr:.0e}, {n_unres} of {n_all} unresolved) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} differs from one process")


def _compare_harness(label: str, ref: list, got: list) -> None:
    """Greedy token for token, each molecule's candidate set, and
    ``corr_sampling_prob`` within 1e-4 relative. Where the candidate sets
    differ, the molecules and their set sizes are printed."""
    greedy = [r.greedy for r in got] == [r.greedy for r in ref]
    cands = lambda rs: [sorted(c.smiles for c in r.candidates) for r in rs]
    bad = [i for i, (a, b) in enumerate(zip(cands(got), cands(ref))) if a != b]
    corr = max(abs(a.corr_sampling_prob - b.corr_sampling_prob)
               / max(abs(b.corr_sampling_prob), 1e-30) for a, b in zip(got, ref))
    ok = greedy and not bad and corr <= 1e-4 and len(got) == len(ref)
    log(f"{label}: greedy {'token-identical' if greedy else 'DIFFERS'}, candidate sets "
        f"{'equal' if not bad else f'DIFFER at molecules {bad}'} "
        f"({sum(len(r.candidates) for r in got)} candidates), corr_sampling_prob within "
        f"{corr:.2e} relative (tol 1e-4) {'ok' if ok else 'FAIL'}")
    for i in bad:
        log(f"[parallel]   molecule {i}: {len(got[i].candidates)} candidates vs "
            f"{len(ref[i].candidates)}; rounds {got[i].sampling_rounds} vs {ref[i].sampling_rounds}")
    if not ok:
        raise AssertionError(f"{label} differs from one process")


def parallel_phase(dev, card: str, phase6_records, main) -> None:
    """Phase 10 (see the module docstring)."""
    import dataclasses

    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.data import samplers
    from multimodalspectraltransformer_torch.parallel.launch import launch
    from multimodalspectraltransformer_torch.parallel.mesh import RankShard

    records, _, dcfg = main
    log(f"[parallel] {card}; two ranks share this card over gloo, so every two-rank figure "
        "below is a time-slicing figure, not a scaling one")
    t_phase = time.perf_counter()
    fp32, fp64, bf16 = _par_cfgs()
    batch = dp.collate([dp.featurize(r, fp32.model) for r in dp.synthetic_dataset(PAR_BATCH, seed=11)])
    opts = dp.FeaturizeOptions(use_given_smiles_form=True)
    n_val = max(1, int(len(phase6_records) * 0.1))
    train_recs = dp.augment_records(phase6_records[:-n_val], 2, seed=0)[: 5 * PAR_BATCH]
    ds_recs = list(phase6_records[:2 * PAR_BATCH + 3])  # 131 rows over 2 shards: one dropped

    # one-process references on this card
    ref = {"dp": _step_result(fp32, batch, None, dev), "tp": _step_result(fp64, batch, None, dev),
           "timing": _median_step_ms(bf16, batch, None, dev)}
    # what drawing dropout at the global shape costs a data-parallel rank: a
    # bf16 step on 32 rows with masks drawn for them, and the same rows as rank
    # 0 of 2 (its masks drawn for 64 rows and sliced; no groups, so no
    # collective runs)
    half = dp.TrainBatch(type(batch.inputs)(*(x[: PAR_BATCH // 2] for x in batch.inputs)),
                         batch.trg_tokens[: PAR_BATCH // 2], batch.trg_fp[: PAR_BATCH // 2])
    ref["draw_local"] = _median_step_ms(bf16, half, None, dev)
    ref["draw_global"] = _median_step_ms(bf16, batch, RankShard(0, 2), dev)
    h_dcfg = dataclasses.replace(dcfg, round_shrink=False)
    ref["h32"] = _harness_run(records, dataclasses.replace(h_dcfg, compute_dtype=None), dev)
    ref["h16"] = _harness_run(records, h_dcfg, dev, warm=True)
    torch.cuda.empty_cache()
    log(f"[parallel] one process: fp32 step loss {ref['dp']['loss']:.6f}, float64 "
        f"{ref['tp']['loss']:.6f}, bf16 step median "
        f"{ref['timing']['step_ms']:.3f} ms at batch {PAR_BATCH}; harness bf16 "
        f"{ref['h16']['summary'].mols_per_sec:.3f} mols/s (K1 {ref['h16']['k1']}, K2 "
        f"{ref['h16']['k2']}); references took {time.perf_counter() - t_phase:.1f} s")
    gib = 1 / (1 << 30)
    log(f"[parallel] dropout drawn for the global batch: a bf16 step on {PAR_BATCH // 2} rows "
        f"{ref['draw_local']['step_ms']:.3f} ms, peak {ref['draw_local']['peak_bytes'] * gib:.3f} "
        f"GiB with their own masks; {ref['draw_global']['step_ms']:.3f} ms, peak "
        f"{ref['draw_global']['peak_bytes'] * gib:.3f} GiB as rank 0 of 2 (masks of "
        f"{PAR_BATCH} rows, sliced); {card}")

    # (a) NCCL, one rank, with deterministic algorithms. cuBLAS gives
    # bitwise-equal results only with one stream active or a fixed workspace;
    # NCCL adds streams, so the rank runs with the fixed workspace (which
    # deterministic algorithms also require).
    t0 = time.perf_counter()
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        a = launch("chip_smoke:_rank_nccl_training", 1, args=(train_recs,), device="cuda",
                   backend="nccl", timeout=300)[0]
    finally:
        if env_before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
    same_loss = a["plain"]["losses"] == a["mesh"]["losses"]
    differ = {k: float((v.double() - a["mesh"]["params"][k].double()).abs().max())
              for k, v in a["plain"]["params"].items() if not torch.equal(v, a["mesh"]["params"][k])}
    same_params = not differ
    worst = max(differ.items(), key=lambda kv: kv[1]) if differ else None
    log(f"[parallel] (a) one rank over {a['mesh']['backend']}, deterministic algorithms: "
        f"run_training 5 bf16 steps with "
        f"make_mesh() vs without: losses {'bit-identical' if same_loss else 'DIFFER'} "
        f"({a['mesh']['losses'][0]:.6f} ... {a['mesh']['losses'][-1]:.6f}), parameters "
        f"{'bit-identical' if same_params else f'DIFFER in {len(differ)} tensors, worst {worst}'}; "
        f"{a['mesh']['secs']:.2f} s vs {a['plain']['secs']:.2f} s; the launch took "
        f"{time.perf_counter() - t0:.1f} s {'ok' if same_loss and same_params else 'FAIL'}")
    if not (same_loss and same_params and len(a["mesh"]["losses"]) == 5):
        raise AssertionError("a one-rank NCCL mesh trains otherwise than no mesh")

    # (b)-(e): two ranks on this card over gloo
    t0 = time.perf_counter()
    out = launch("chip_smoke:_rank_parallel", 2, args=(batch, records, ds_recs), device="cuda",
                 backend="gloo", timeout=600)
    log(f"[parallel] two-rank launch over gloo took {time.perf_counter() - t0:.1f} s")
    r0 = out[0]
    lr = fp32.train.learning_rate
    heads, ffn = fp32.model.num_heads // 2, fp32.model.ffn_dim // 2
    for name, what in (("dp", f"(b) DP, (data 2), {PAR_BATCH // 2} rows a rank, one fp32 step"),
                       ("tp", f"(c) TP, (data 1, model 2), {heads} heads and {ffn} feed-forward "
                              "columns a rank, one float64 step")):
        if out[1][name]["loss"] != r0[name]["loss"]:
            raise AssertionError(f"{name}: the ranks report other losses")
        _compare_parallel(f"[parallel] {what} from phase3 (dropout on, batch {PAR_BATCH})",
                          ref[name], r0[name], lr)
    rows = []
    for name in ("dp", "tp"):
        t = [o[name + "_timing"] for o in out]
        step_ms = max(x["step_ms"] for x in t)
        extra = ""
        if "all_reduce_ms" in t[0]:
            ar = max(x["all_reduce_ms"] for x in t)
            extra = (f", gradient all-reduce {ar:.3f} ms for {t[0]['all_reduce_bytes'] / 1e6:.1f} MB "
                     f"({t[0]['all_reduce_bytes'] / ar / 1e6:.2f} GB/s)")
        log(f"[parallel] bf16 step at batch {PAR_BATCH}, {name.upper()} over 2 ranks: median "
            f"{step_ms:.3f} ms (slowest rank) against {ref['timing']['step_ms']:.3f} ms in one "
            f"process{extra}; {card}")
    host_ms = _host_loader_ms(ds_recs, fp32.model)
    log(f"[parallel] host loader, stochastic featurization ({HOST_OPTS}): "
        f"{host_ms:.1f} ms a batch of {PAR_BATCH} in one process; "
        + ", ".join(f"rank {r}: {o['host_loader_ms']:.1f} ms for its {PAR_BATCH // 2} rows"
                    for r, o in enumerate(out))
        + " (each rank still draws every row's random stream and checks its chemistry)")
    # (d)
    _compare_harness(f"[parallel] (d) sharded harness, {len(records)} molecules over 2 ranks, "
                     f"float32, fan-out {dcfg.fanout}, round-shrink off on both sides",
                     ref["h32"]["results"], r0["harness_fp32"]["results"])
    mps = r0["harness_bf16"]["summary"].mols_per_sec
    launches = [(o["harness_bf16"]["k1"], o["harness_bf16"]["k2"]) for o in out]
    log(f"[parallel] (d) bf16: {mps:.3f} mols/s over 2 ranks (slowest rank's clock) against "
        f"{ref['h16']['summary'].mols_per_sec:.3f} in one process; launches per rank "
        + ", ".join(f"rank {r}: K1={k1n} K2={k2n}" for r, (k1n, k2n) in enumerate(launches))
        + f"; {card}")
    if any(k1n <= 0 or k2n <= 0 for k1n, k2n in launches):
        raise AssertionError("a rank of the sharded harness launched K1 or K2 no time")
    # (e): the rows the port's own copy of JAX's epoch_row_batches_sharded picks
    ldr = dp.Loader(ds_recs, fp32.model, batch_size=PAR_BATCH, seed=1)
    big, kept = ldr._featurize_all(1 << 40)
    smiles = [ds_recs[int(i)].smiles for i in kept]
    Rl, bsl = len(smiles) // 2, PAR_BATCH // 2
    orders = [samplers.epoch_order(ldr.order_strategy, smiles[d * Rl : (d + 1) * Rl], bsl,
                                   ldr.seed * 1_000_003 + d, 0) for d in range(2)]
    host = dp.to_device(big, "cpu")
    n_checked = 0
    for o in out:
        d = o["dataset"]["index"]
        if o["dataset"]["kept"] != smiles[: 2 * Rl] or len(o["dataset"]["batches"]) != Rl // bsl:
            raise AssertionError("the sharded dataset keeps other rows")
        for i, (idx, trg, c13, fp) in enumerate(o["dataset"]["batches"]):
            want = np.concatenate([np.asarray(orders[e][i * bsl : (i + 1) * bsl]) for e in range(2)])
            if not np.array_equal(idx, want):
                raise AssertionError("epoch_row_batches_sharded picks other rows")
            exp = dp.gather_rows(host, d * Rl + want[d * bsl : (d + 1) * bsl])
            if not (torch.equal(trg, exp.trg_tokens) and torch.equal(c13, exp.inputs.src_13c)
                    and torch.equal(fp, exp.trg_fp)):
                raise AssertionError("a rank's gathered batch differs from its rows")
            n_checked += 1
    log(f"[parallel] (e) sharded device dataset, {len(ds_recs)} records over 2 ranks "
        f"({Rl} rows a partition): {n_checked} gathered batches equal the rows of the port's "
        "copy of epoch_row_batches_sharded ok")
    log(f"[parallel] the phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the evaluation and data drivers
# ---------------------------------------------------------------------------

DRIVERS_OUT = os.path.join("chiprun_out", "drivers")


def _load_file(rel: str):
    """A script or example of the repository, loaded as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3], rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _quiet(log_path: str):
    """Standard output of the block appended to ``log_path`` (the drivers
    print their whole reports)."""
    with open(log_path, "a") as f, contextlib.redirect_stdout(f):
        yield


def _launch_counts() -> dict:
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import beam_attention as k3
    from multimodalspectraltransformer_torch.ops import decode_attention as k1

    return {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}


def _reset_launches() -> None:
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import beam_attention as k3
    from multimodalspectraltransformer_torch.ops import decode_attention as k1

    for mod in (k1, k2, k3):
        mod.reset_launches()


def _record_fields(r) -> tuple:
    return (r.sample_id, r.smiles, r.h1, r.c13, r.hsqc, r.cosy)


def drivers_report(dev, card: str, log_path: str) -> list:
    """(a): the accuracy report generated from scratch, resumed, read from its
    records cache, and with ``--sim-weights`` at the committed shift weights
    and at others; returns the held-out SMILES."""
    import shutil

    import torch

    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.sim import distill

    acc = _load_file(os.path.join("scripts", "torch_accuracy_report.py"))
    out = os.path.join(DRIVERS_OUT, "acc")
    cache = os.path.join(DRIVERS_OUT, "heldout_csv") + "/"

    def argv(out_dir, *extra):
        return ["--params", PHASE3, "--train-n", "2000", "--train-seed", "11", "--heldout-seed",
                "999", "--n", "16", "--mw-band", "0,350", "--chunk-size", "8", "--beam", "5",
                "--mix", "--rounds", "2", "--clip-params", CLIP_R4, "--records-cache", cache,
                "--out", out_dir, "--report-dir", out_dir, "--tag", "drivers", *extra]

    def run(out_dir, *extra):
        _reset_launches()
        t0 = time.perf_counter()
        with _quiet(log_path):
            res = acc.run(acc.parse_args(argv(out_dir, *extra)))
        return res, time.perf_counter() - t0, _launch_counts()

    first, secs, launches = run(out)
    rep = first["report"]
    if rep["n"] != 16 or not os.path.exists(os.path.join(cache, "data_1H_0.csv")):
        raise AssertionError(f"the report evaluated {rep['n']} molecules or wrote no records cache")
    if any(launches[k] <= 0 for k in ("K1", "K2", "K3")):
        raise AssertionError(f"the report with --beam 5 launched {launches}")
    t = first["seconds"]
    per_chunk = ", ".join(f"{len(c['molecules']) / c['wall_s']:.3f}" for c in first["chunks"])
    log(f"[drivers] (a) report from scratch: 16 held-out molecules (train 2000, MW 0-350), "
        f"2 chunks of 8, fan-out 128, 2 rounds, beam 5, greedy in pool, clip_r4, bf16: "
        f"{secs:.2f} s (held-out list {t['heldout']:.2f} s, records simulated on the card "
        f"{t['records']:.2f} s, chunks {t['chunks']:.2f} s); mols/s per chunk {per_chunk}; "
        f"launches K1={launches['K1']} K2={launches['K2']} K3={launches['K3']}; greedy exact "
        f"{rep['greedy_exact']:.4f}, MNS {rep['mns_exact']:.4f}, top-1 by error "
        f"{rep['top_k_by_error'].get('1', float('nan')):.4f}; {card}")
    log("[drivers] (a) stage seconds: " + ", ".join(f"{k} {v:.3f}"
                                                   for k, v in rep["stage_seconds"].items()))

    second, secs2, launches2 = run(out)
    keep = lambda r, drop=("wall_s_total",): {k: v for k, v in r.items() if k not in drop}
    same = keep(second["report"]) == keep(rep)
    log(f"[drivers] (a) resumed: {secs2:.2f} s, launches {launches2}, report numbers "
        f"{'equal' if same else 'DIFFER'}")
    if any(launches2.values()) or not same:
        raise AssertionError("the resumed report recomputed a chunk or reports other numbers")

    # a fresh --out reads the records cache the first run wrote
    for d in ("acc_cache", "acc_simw", "acc_moved"):
        os.makedirs(os.path.join(DRIVERS_OUT, d), exist_ok=True)
        shutil.copy(os.path.join(out, "heldout_smiles.json"), os.path.join(DRIVERS_OUT, d))
    # what the harness is given and gives back in each chunk of the runs below
    seen = []
    real_evaluate = harness.evaluate_molecules

    def spy(*a, **k):
        res = real_evaluate(*a, **k)
        seen.append((k["sim_kwargs"], res[0]))
        return res

    harness.evaluate_molecules = spy
    try:
        third, secs3, _ = run(os.path.join(DRIVERS_OUT, "acc_cache"))
        fourth, secs4, _ = run(os.path.join(DRIVERS_OUT, "acc_simw"), "--sim-weights",
                               distill.WEIGHTS_DIR)
        # the committed shift weights scaled by 1.1: the candidates' errors move
        moved, _ = distill.load_shift_weights(distill.WEIGHTS_DIR, dev)
        with torch.no_grad():
            for p in moved.parameters():
                p.mul_(1.1)
        with open(os.path.join(distill.WEIGHTS_DIR, "nmr_shift.json")) as f:
            meta = json.load(f)
        moved_dir = os.path.join(DRIVERS_OUT, "shift_moved")
        distill.save_shift_weights(moved, meta["stats"], meta["report"], moved_dir)
        fifth, secs5, _ = run(os.path.join(DRIVERS_OUT, "acc_moved"), "--sim-weights", moved_dir)
    finally:
        harness.evaluate_molecules = real_evaluate
    a, b = first["records"], third["records"]
    same_records = ([_record_fields(r) for r in a] == [_record_fields(r) for r in b]
                    and all(np.array_equal(np.asarray(y.ir, np.float32), x.ir)
                            for x, y in zip(a, b)))
    log(f"[drivers] (a) from the records cache: {len(b)} records "
        f"{'equal' if same_records else 'DIFFER'} to the simulated ones (IR as float32); "
        f"{secs3:.2f} s")
    if not same_records:
        raise AssertionError("the records cache reads back other records")
    drop = ("wall_s_total", "stage_seconds", "sim_weights", "heldout")
    same_sw = keep(fourth["report"], drop) == keep(third["report"], drop)
    committed, _ = distill.load_shift_weights(distill.WEIGHTS_DIR, dev)
    n_chunks = len(first["chunks"])
    given = [sim for sim, _ in seen]
    reached = (len(given) == 3 * n_chunks and given[:n_chunks] == [None] * n_chunks
               and all(_same_weights(sim["shift_model"], committed)
                       for sim in given[n_chunks:2 * n_chunks])
               and all(_same_weights(sim["shift_model"], moved) for sim in given[2 * n_chunks:]))
    log(f"[drivers] (a) --sim-weights {distill.WEIGHTS_DIR}: report "
        f"{'equal' if same_sw else 'DIFFERS'} to the run without it; {secs4:.2f} s; the "
        f"harness {'got' if reached else 'did NOT get'} the model of each --sim-weights")
    if not same_sw:
        raise AssertionError("--sim-weights at the committed weights changed the report")
    if not reached:
        raise AssertionError("the shift model of --sim-weights did not reach the harness")

    def errors(results):
        return [(c.smiles, c.hsqc_error, c.cosy_error) for rs in results for r in rs
                for c in r.candidates]

    plain = errors(res for _, res in seen[:n_chunks])
    shifted = errors(res for _, res in seen[2 * n_chunks:])
    n_moved = sum(bool(np.isfinite(a[1:] + b[1:]).all()) and a[1:] != b[1:]
                  for a, b in zip(plain, shifted))
    log(f"[drivers] (a) --sim-weights at the committed weights scaled by 1.1: the same "
        f"{len(shifted)} candidates, {n_moved} with other HSQC/COSY errors; {secs5:.2f} s")
    if [c[0] for c in plain] != [c[0] for c in shifted] or not n_moved:
        raise AssertionError("other shift weights left the candidates' errors where they were")
    return [r.smiles for r in first["records"]]


def _same_weights(a, b) -> bool:
    """Whether two modules hold equal tensors under the same names."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def drivers_sweep(heldout: list, card: str, log_path: str) -> None:
    """(b): the chunked sweep over two shards against one shard."""
    sweep = _load_file(os.path.join("scripts", "torch_eval_sweep.py"))
    smiles = os.path.join(DRIVERS_OUT, "sweep_smiles.txt")
    with open(smiles, "w") as f:
        f.write("\n".join(heldout) + "\n")
    common = ["--smiles", smiles, "--chunk-size", "4", "--params", PHASE3, "--rounds", "2"]
    one, two = os.path.join(DRIVERS_OUT, "sweep1"), os.path.join(DRIVERS_OUT, "sweep2")
    t0 = time.perf_counter()
    with _quiet(log_path):
        sweep.main([*common, "--out", one])
        t1 = time.perf_counter()
        for s in (0, 1):
            sweep.main([*common, "--out", two, "--shard", str(s), "--num-shards", "2"])
    t2 = time.perf_counter()
    with open(os.path.join(one, "summary.json")) as f:
        a = json.load(f)
    with open(os.path.join(two, "summary.json")) as f:
        b = json.load(f)
    chunks_equal = True
    for ci in range(4):
        with open(os.path.join(one, f"chunk_{ci:04d}.json")) as f:
            x = json.load(f)
        with open(os.path.join(two, f"chunk_{ci:04d}.json")) as f:
            y = json.load(f)
        chunks_equal &= x["digest"] == y["digest"] and x["molecules"] == y["molecules"]
    ok = (chunks_equal and a["n"] == b["n"] == len(heldout)
          and a["greedy_exact"] == b["greedy_exact"]
          and abs(a["mean_greedy_tanimoto"] - b["mean_greedy_tanimoto"]) <= 1e-12)
    with open(os.path.join(one, "summary_shard0.json")) as f:
        mps = json.load(f)["mols_per_sec"]
    log(f"[drivers] (b) sweep, {len(heldout)} molecules in chunks of 4 (phase3, fan-out 128, 2 "
        f"rounds, float32): one shard {t1 - t0:.2f} s ({mps:.3f} mols/s in its chunks), two "
        f"shards in turn {t2 - t1:.2f} s; merged greedy exact {b['greedy_exact']:.4f} and "
        f"tanimoto {b['mean_greedy_tanimoto']:.6f} {'equal' if ok else 'DIFFER'} to one shard's, "
        f"every chunk {'equal' if chunks_equal else 'DIFFERS'}; {card}")
    if not ok:
        raise AssertionError("the merged sweep differs from the one-shard sweep")


def drivers_cache_and_checkpoints(dev, card: str, log_path: str, tmp: str) -> None:
    """(c) the factory-cache builder and ``cli train`` from its cache; (d)
    three ``run_training`` snapshots averaged and exported."""
    import torch

    from multimodalspectraltransformer_torch import cli
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import convert
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.train import checkpoint as ckpt
    from multimodalspectraltransformer_torch.train.loop import run_training
    from multimodalspectraltransformer_torch.utils.config import (DataConfig, MMTConfig,
                                                                  ModelConfig, TrainConfig)

    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(molrandom.random_corpus(64, seed=4242)) + "\n")
    cache = os.path.join(DRIVERS_OUT, "factory64.pkl")
    builder = _load_file(os.path.join("scripts", "torch_build_factory_cache.py"))
    t0 = time.perf_counter()
    with _quiet(log_path):
        builder.main(["--corpus", corpus, "--n", "64", "--seed", "4242", "--out", cache,
                      "--chunk", "32", "--checkpoint-every", "1"])
    secs = time.perf_counter() - t0
    records = dp.load_records_pickle(cache)["records"]

    real = factory.simulate_records

    def refuse(*a, **k):
        raise AssertionError("cli train simulated records despite --factory-cache")

    factory.simulate_records = refuse
    try:
        t1 = time.perf_counter()
        with _quiet(log_path):
            rc = cli.main(["train", "--factory", "64", "--factory-seed", "4242", "--factory-cache",
                           cache, "--steps", "2", "--batch-size", "16", "--bf16",
                           "--out", os.path.join(tmp, "train")])
        secs_train = time.perf_counter() - t1
    finally:
        factory.simulate_records = real
    with open(log_path) as f:
        line = json.loads([ln for ln in f.read().splitlines() if ln.startswith('{"steps"')][-1])
    log(f"[drivers] (c) cache builder: {len(records)} records of 64 molecules in {secs:.2f} s "
        f"({len(records) / secs:.2f} mols/s, simulated on the card, 2 chunks of 32); cli train "
        f"--factory 64 --factory-cache, 2 bf16 steps at full width: rc {rc}, steps "
        f"{line['steps']}, loss {line['train_loss']:.4f}, {secs_train:.2f} s, nothing simulated; "
        f"{card}")
    if rc != 0 or line["steps"] != 2 or len(records) != 64:
        raise AssertionError("cli train did not take 2 steps on the builder's cache")

    # (d) three snapshots of run_training at full width
    run_dir = os.path.join(tmp, "run")
    cfg = MMTConfig(model=ModelConfig(), train=TrainConfig(learning_rate=3e-5,
                                                           mixed_precision=True,
                                                           save_interval_steps=1,
                                                           keep_checkpoints=3),
                    data=DataConfig(batch_size=16))
    t2 = time.perf_counter()
    run_training(cfg, dp.Loader(records, cfg.model, batch_size=16), max_steps=3,
                 checkpoint_dir=os.path.join(run_dir, "ckpt"), device=dev)
    t3 = time.perf_counter()
    mgr = ckpt.CheckpointManager(os.path.join(run_dir, "ckpt"))
    snaps = [mgr.restore_params(s) for s in mgr.steps()]
    avg_path = os.path.join(tmp, "avg.msgpack")
    with _quiet(log_path):
        rc_avg = _load_file(os.path.join("scripts", "torch_average_checkpoints.py")).main(
            ["--ckpt-dir", os.path.join(run_dir, "ckpt"), "--out", avg_path])
        rc_bf16 = _load_file(os.path.join("scripts", "torch_export_latest.py")).main(
            [run_dir, os.path.join(tmp, "latest.msgpack.gz")])
    t4 = time.perf_counter()
    got = convert.from_jax_params(convert.read_msgpack(avg_path))
    mean_ok = all(np.array_equal(
        got[k].numpy(), (sum(s[k].numpy().astype(np.float64) for s in snaps) / 3.0).astype(np.float32))
        for k in snaps[0])
    bf16 = convert.read_msgpack(os.path.join(tmp, "latest.msgpack.gz"))
    want = convert.to_jax_params(snaps[-1])
    flat = lambda t: [v for _, v in sorted(_flatten(t).items())]
    bf16_ok = all(x.dtype == torch.bfloat16 and torch.equal(x, torch.from_numpy(y).to(torch.bfloat16))
                  for x, y in zip(flat(bf16), flat(want)))
    moved = max(float((snaps[2][k] - snaps[0][k]).abs().max()) for k in snaps[0])
    log(f"[drivers] (d) run_training 3 bf16 steps at full width with a snapshot a step "
        f"({mgr.steps()}) in {t3 - t2:.2f} s; the average {'equals' if mean_ok else 'DIFFERS from'} "
        f"the float64 numpy mean, leaf for leaf (the snapshots move by up to {moved:.3e}); the bf16 "
        f"export of the newest {'equals' if bf16_ok else 'DIFFERS from'} its parameters rounded "
        f"to bf16; averaging and export {t4 - t3:.2f} s")
    if rc_avg != 0 or rc_bf16 != 0 or mgr.steps() != [1, 2, 3] or not (mean_ok and bf16_ok) \
            or not moved > 0:
        raise AssertionError("the checkpoint averaging or the bf16 export is wrong")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def drivers_examples(dev, card: str, log_path: str) -> None:
    """(e): the four examples on the card at the JAX examples' settings."""
    examples = (
        ("torch_01_data_generation",
         lambda m: m.main(os.path.join(DRIVERS_OUT, "example01"), device=dev),
         lambda out: len(out) == 4),
        ("torch_02_train_and_evaluate", lambda m: m.main(device=dev),
         lambda out: out[0].steps > 0 and out[1].n == 8),
        ("torch_03_explainability",
         lambda m: m.main(os.path.join(DRIVERS_OUT, "example03.svg"), device=dev),
         lambda out: len(out["atom_values"]) > 0),
        ("torch_04_improvement_cycle", lambda m: m.main(device=dev),
         lambda out: [r.cycle for r in out] == [0, 1]),
    )
    times = {}
    for name, call, ok in examples:
        mod = _load_file(os.path.join("examples", name + ".py"))
        t0 = time.perf_counter()
        with _quiet(log_path):
            out = call(mod)
        times[name] = time.perf_counter() - t0
        if not ok(out):
            raise AssertionError(f"examples/{name}.py did not give what it should")
    log("[drivers] (e) examples on the card: " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
        + f"; {card}")


def drivers_phase(dev, card: str) -> None:
    """Phase 11 (see the module docstring)."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    shutil.rmtree(DRIVERS_OUT, ignore_errors=True)
    os.makedirs(DRIVERS_OUT)
    log_path = os.path.join(DRIVERS_OUT, "drivers.log")
    heldout = drivers_report(dev, card, log_path)
    drivers_sweep(heldout, card, log_path)
    torch.cuda.empty_cache()
    # snapshots of the full model (about 300 MB each) stay out of chiprun_out
    with tempfile.TemporaryDirectory() as tmp:
        drivers_cache_and_checkpoints(dev, card, log_path, tmp)
    drivers_examples(dev, card, log_path)
    log(f"[drivers] the phase took {time.perf_counter() - t_phase:.1f} s (the drivers' own output: "
        f"{log_path})")


# ---------------------------------------------------------------------------
# phase 12: the reference-test-set adaptation scripts ("campaign")
# ---------------------------------------------------------------------------

CAMPAIGN_OUT = os.path.join("chiprun_out", "campaign")
SGNN_WEIGHTS = os.path.join("multimodalspectraltransformer_tpu", "sim", "weights_sgnn")


def _plain(points) -> list:
    """Peaks as Python floats (a list of numbers or of pairs)."""
    return [float(p) if np.ndim(p) == 0 else [float(v) for v in p] for p in points]


def write_reference_testset(out_dir: str, chc_records, h1_records) -> None:
    """Records in the shipped test set's headerless format, a
    ``SMILES,"[data]",sample-id`` row each, as ``load_reference_testset``
    reads it: 13C, HSQC and COSY of ``chc_records``, 1H of ``h1_records``."""
    import csv

    from multimodalspectraltransformer_torch.data.pipeline import REF_TESTSET_FILES

    os.makedirs(out_dir, exist_ok=True)
    for key, attr, recs in (("13c", "c13", chc_records), ("hsqc", "hsqc", chc_records),
                            ("cosy", "cosy", chc_records), ("1h", "h1", h1_records)):
        with open(os.path.join(out_dir, REF_TESTSET_FILES[key]), "w", newline="") as f:
            w = csv.writer(f)
            for r in recs:
                w.writerow([r.smiles, json.dumps(_plain(getattr(r, attr))), r.sample_id])


def campaign_testset(dev, out_dir: str, n: int = 96, seed: int = 250) -> tuple[list, list]:
    """A stand-in for the shipped test set, written to ``out_dir``: two
    disjoint sets of ``n`` molecules of ``random_corpus(2n, min_mw=250,
    max_mw=350)`` with ids of both halves of the split, simulated on ``dev``
    by the committed shift weights with every parameter scaled by 1.1
    ("another simulator"), no IR: 13C, HSQC and COSY of the first set, 1H of
    the second. It measures nothing of the reference's data."""
    import torch

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import distill, factory

    smiles = molrandom.random_corpus(2 * n, seed=seed, min_mw=250.0, max_mw=350.0)
    if len(smiles) < 2 * n:
        raise AssertionError(f"random_corpus gave {len(smiles)} of {2 * n} molecules")
    other, stats = distill.load_shift_weights(distill.WEIGHTS_DIR, dev)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1.1)
    recs = factory.simulate_records(smiles, sample_ids=[f"ZINC{seed:04d}{i:08d}" for i in
                                                        range(2 * n)],
                                    shift_model=other, stats=stats, with_ir=False, device=dev)
    if len(recs) != 2 * n:
        raise AssertionError(f"{len(recs)} of {2 * n} stand-in molecules simulated")
    chc, h1 = recs[:n], recs[n:]
    write_reference_testset(out_dir, chc, h1)
    return chc, h1


def campaign_adapt(dev, card: str, ref_dir: str, log_path: str) -> str:
    """(b): ``torch_sgnn_adapt`` on the stand-in, 300 steps at batch 128 on
    the card; returns the adapted weights' directory."""
    import torch

    from multimodalspectraltransformer_torch.sim import distill

    adapt = _load_file(os.path.join("scripts", "torch_sgnn_adapt.py"))
    report_dir = os.path.join(CAMPAIGN_OUT, "sgnn_adapt")
    weights = os.path.join(report_dir, "weights_sgnn")
    fit = {}
    real_train = distill.train_shift_model

    def timed(data, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_train(data, **kw)
        torch.cuda.synchronize()
        fit.update(seconds=time.perf_counter() - t0, steps=kw["n_steps"], device=str(kw["device"]))
        return out

    distill.train_shift_model = timed
    t0 = time.perf_counter()
    try:
        with _quiet(log_path):
            rc = adapt.main(["--ref-dir", ref_dir, "--steps", "300", "--batch-size", "128",
                             "--out", weights, "--report", report_dir])
    finally:
        distill.train_shift_model = real_train
    secs = time.perf_counter() - t0
    with open(os.path.join(report_dir, "report.json")) as f:
        report = json.load(f)
    info = report["assignment"]
    before, after = report["eval_before"], report["eval_after"]
    mae = [r["chc_eval"]["c13_nn_mae_ppm"] for r in (before, after)]
    log(f"[campaign] (b) torch_sgnn_adapt: assignment dataset {info}; fine-tune 300 steps at "
        f"batch 128 on {fit.get('device')}: {fit.get('seconds', float('nan')):.2f} s, "
        f"{1e3 * fit.get('seconds', float('nan')) / 300:.3f} ms a step (validation included); "
        f"eval half 13C nearest-peak MAE {mae[0]:.4f} -> {mae[1]:.4f} ppm, HSQC match "
        f"{before['chc_eval']['hsqc_match_dist']:.4f} -> {after['chc_eval']['hsqc_match_dist']:.4f}, "
        f"1H centroid MAE {before['h1_eval']['h1_centroid_nn_mae_ppm']:.4f} -> "
        f"{after['h1_eval']['h1_centroid_nn_mae_ppm']:.4f} ppm; {secs:.2f} s in all; {card}")
    if rc != 0 or torch.device(fit.get("device", "meta")).type != dev.type or info["mols"] <= 0:
        raise AssertionError(f"torch_sgnn_adapt did not fine-tune on {dev}")
    if not mae[1] < mae[0]:
        raise AssertionError(f"the eval half's 13C MAE did not fall: {mae[0]} -> {mae[1]}")
    if distill.load_shift_weights(weights, dev) is None:
        raise AssertionError("the adapted weights do not load")
    return weights


def campaign_corpora(dev, card: str, ref_dir: str, weights: str, log_path: str) -> None:
    """(c): the corpus chain on the card's outputs, each pickle's count and
    ids checked, then ``cli train`` from the mixture with the simulator
    refused."""
    import tempfile

    from multimodalspectraltransformer_torch import cli
    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.sim import factory

    out = os.path.join(CAMPAIGN_OUT, "corpora")
    os.makedirs(out)
    chc, h1 = dp.load_reference_sets(ref_dir)
    adapt_ids = [r.sample_id for r in chc if dp.ref_testset_split(r.sample_id) == "adapt"]
    evals = {chem.canonicalize(r.smiles) for r in chc + h1
             if dp.ref_testset_split(r.sample_id) == "eval"}
    secs = {}

    def run(name: str, argv: list) -> None:
        t0 = time.perf_counter()
        with _quiet(log_path):
            rc = _load_file(os.path.join("scripts", name + ".py")).main(argv)
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name} returned {rc}")

    zc_txt, zc_pkl = os.path.join(out, "zinclike.txt"), os.path.join(out, "factory_zinc.pkl")
    run("torch_zinc_corpus", ["--out", zc_txt, "--n", "256", "--ref-dir", ref_dir])
    with open(zc_txt) as f:
        zinc = f.read().split()
    if len(zinc) != 256 or len(set(zinc)) != 256 or evals & set(zinc):
        raise AssertionError(f"the zinclike corpus holds {len(zinc)} molecules, "
                             f"{len(set(zinc))} distinct, {len(evals & set(zinc))} of the eval half")
    run("torch_build_factory_cache", ["--corpus", zc_txt, "--n", "256", "--seed", "41", "--out",
                                      zc_pkl, "--chunk", "128"])
    zc = dp.load_records_pickle(zc_pkl)
    if (zc["n"], zc["seed"]) != (256, 41) or not zc["records"] or any(
            r.sample_id != f"f{zinc.index(r.smiles)}" for r in zc["records"]):
        raise AssertionError("the zinclike factory cache does not hold the corpus it was given")
    mem_pkl = os.path.join(out, "factory_adapt_mem.pkl")
    run("torch_r4_mem_control", ["--out", mem_pkl, "--dup", "4", "--ref-dir", ref_dir])
    mem = dp.load_records_pickle(mem_pkl)
    if [r.sample_id for r in mem["records"]] != [f"{i}_m{d}" for d in range(4) for i in adapt_ids]:
        raise AssertionError("the memorization cache's ids are not the adapt half 4 times")
    mix_pkl = os.path.join(out, "factory_zc2.pkl")
    run("torch_build_mixture_corpus", ["--zc", zc_pkl, "--mem", mem_pkl, "--dup", "8", "--out",
                                       mix_pkl, "--key-seed", "777"])
    mix = dp.load_records_pickle(mix_pkl)
    want = sorted([r.sample_id for r in zc["records"]]
                  + [f"{i}_x{d}" for d in range(8) for i in adapt_ids])
    if mix["n"] != len(want) or sorted(r.sample_id for r in mix["records"]) != want:
        raise AssertionError("the mixture does not hold the zinclike records and 8 of each unique")
    corpus = os.path.join(out, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(molrandom.random_corpus(512, seed=2424, min_mw=200.0, max_mw=400.0)) + "\n")
    sgnn_pkl = os.path.join(out, "factory_sgnn.pkl")
    sim = {"records": 0, "seconds": 0.0}
    real_simulate = factory.simulate_records

    def timed(*a, **k):
        t0 = time.perf_counter()
        recs = real_simulate(*a, **k)
        sim["seconds"] += time.perf_counter() - t0
        sim["records"] += len(recs)
        return recs

    factory.simulate_records = timed
    try:
        run("torch_build_sgnn_corpus", ["--corpus", corpus, "--orig-cache", zc_pkl, "--weights",
                                        weights, "--out", sgnn_pkl, "--n", "256", "--real-dup", "2",
                                        "--orig-frac", "0.25", "--chunk", "128", "--ref-dir", ref_dir])
    finally:
        factory.simulate_records = real_simulate
    sg = dp.load_records_pickle(sgnn_pkl)
    n_real = sum(dp.ref_testset_split(r.sample_id) == "adapt" for r in chc + h1)
    ids = [r.sample_id for r in sg["records"]]
    if (ids[:256] != [f"a{i}" for i in range(256)] or sg["n"] != 256 + 2 * n_real + 64
            or any(r.ir is not None for r in sg["records"][:256])):
        raise AssertionError(f"the SGNN corpus holds {sg['n']} records, not 256 simulated, "
                             f"{2 * n_real} real and 64 anchors")

    real_sim = factory.simulate_records

    def refuse(*a, **k):
        raise AssertionError("cli train simulated records despite --factory-cache")

    factory.simulate_records = refuse
    try:
        t0 = time.perf_counter()
        # the run's full-model files stay out of chiprun_out
        with tempfile.TemporaryDirectory() as tmp, _quiet(log_path):
            rc = cli.main(["train", "--factory", str(mix["n"]), "--factory-seed", "777",
                           "--factory-cache", mix_pkl, "--steps", "2", "--batch-size", "16",
                           "--bf16", "--out", tmp])
        secs["cli train"] = time.perf_counter() - t0
    finally:
        factory.simulate_records = real_sim
    with open(log_path) as f:
        line = json.loads([ln for ln in f.read().splitlines() if ln.startswith('{"steps"')][-1])
    if rc != 0 or line["steps"] != 2 or not np.isfinite(line["train_loss"]):
        raise AssertionError("cli train did not take 2 steps on the mixture")
    log(f"[campaign] (c) corpora: zinclike {len(zinc)} molecules, its cache {len(zc['records'])} "
        f"records; memorization {mem['n']} ({len(adapt_ids)} adapt x 4); mixture {mix['n']}; SGNN "
        f"corpus {sg['n']} (256 simulated by the adapted weights at "
        f"{sim['records'] / sim['seconds']:.1f} mols/s on the card, {2 * n_real} real, 64 "
        f"anchors); cli train from the mixture 2 bf16 steps, loss {line['train_loss']:.4f}, "
        f"nothing simulated; seconds " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; {card}")


def campaign_control(dev, card: str, ref_dir: str, weights: str, log_path: str) -> None:
    """(d): ``torch_control_adapted_sim_eval`` on 8 molecules of the adapt
    half with the adapted weights, the K1 and K2 launches counted."""
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.sim import distill

    control = _load_file(os.path.join("scripts", "torch_control_adapted_sim_eval.py"))
    out = os.path.join(CAMPAIGN_OUT, "control_adapted_sim_adapt.json")
    seen = []
    real_evaluate = harness.evaluate_molecules

    def spy(*a, **k):
        t0 = time.perf_counter()
        res = real_evaluate(*a, **k)
        seen.append((k["sim_kwargs"], res, time.perf_counter() - t0))
        return res

    harness.evaluate_molecules = spy
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with _quiet(log_path):
            rc = control.main(["--params", PHASE3, "--n", "8", "--chunk-size", "8", "--sim-weights",
                               weights, "--ref-dir", ref_dir, "--out", out])
    finally:
        harness.evaluate_molecules = real_evaluate
    secs = time.perf_counter() - t0
    launches = _launch_counts()
    with open(out) as f:
        summary = json.load(f)
    adapted, _ = distill.load_shift_weights(weights, dev)
    errs = [e for _, (results, _), _ in seen for r in results for c in r.candidates
            for e in (c.hsqc_error, c.cosy_error) if not np.isnan(e)]
    eval_s = sum(s for _, _, s in seen)
    log(f"[campaign] (d) torch_control_adapted_sim_eval: {summary['n']} adapt-half molecules "
        f"simulated and scored by the adapted weights, fan-out 128, 10 rounds, bf16: launches "
        f"K1={launches['K1']} K2={launches['K2']} K3={launches['K3']}; evaluate "
        f"{summary['n'] / eval_s:.3f} mols/s ({eval_s:.2f} s), the script {secs:.2f} s; greedy "
        f"{summary['greedy_exact']:.4f}, MNS {summary['mns_exact']:.4f}; {len(errs)} scored "
        f"errors, all finite: {bool(np.isfinite(errs).all())}; {card}")
    if rc != 0 or summary["n"] != 8 or launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"the control evaluated {summary['n']} molecules, launches {launches}")
    if not errs or not np.isfinite(errs).all():
        raise AssertionError("the control scored no pair, or a pair's error is not finite")
    if not all(_same_weights(sim["shift_model"], adapted) for sim, _, _ in seen):
        raise AssertionError("the harness did not get the adapted weights of --sim-weights")


def campaign_real_data(dev, card: str, chc: list, log_path: str) -> None:
    """(e): ``torch_real_data_demo`` on 5 records of the stand-in in the AZ
    format, cut: every fold's frozen tensors bit-equal to phase3."""
    import torch

    from multimodalspectraltransformer_torch.models import convert
    from multimodalspectraltransformer_torch.train import checkpoint as ckpt
    from multimodalspectraltransformer_torch.train.state import trainable_parameters
    from multimodalspectraltransformer_torch.utils.config import ModelConfig, TrainConfig

    demo = _load_file(os.path.join("scripts", "torch_real_data_demo.py"))
    az = os.path.join(CAMPAIGN_OUT, "az")
    write_az_example(az, chc[:5])
    phase3 = ckpt.import_params_msgpack(PHASE3)
    folds = []
    real_fold, real_evaluate = demo.train_fold, demo.evaluate

    def checked_fold(params, records, held, mcfg, trainable, steps, lr, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real_fold(params, records, held, mcfg, trainable, steps, lr, **kw)
        torch.cuda.synchronize()
        model = result.state.model
        picked = {id(p) for p in trainable_parameters(TrainConfig(trainable_only=trainable), model)}
        frozen_equal = moved = 0
        for name, p in model.named_parameters():
            same = torch.equal(p.detach().cpu(), phase3[name])
            if id(p) in picked:
                moved += not same
            else:
                frozen_equal += same
                if not same:
                    raise AssertionError(f"fold {held} ({trainable}) moved frozen tensor {name}")
        paths = convert.jax_paths(dict(model.named_parameters()))
        tops = sorted({paths[n].split("/")[0] for n, p in model.named_parameters()
                       if id(p) in picked})
        folds.append(dict(trainable=trainable, held=held, seconds=time.perf_counter() - t0,
                          frozen_equal=frozen_equal, moved=moved, n_picked=len(picked), tops=tops))
        return result

    blend = {"launches": 0, "calls": 0}

    def counted_evaluate(records, model, dcfg, **kw):
        before = _launch_counts()["K1"]
        out = real_evaluate(records, model, dcfg, **kw)
        if model.cfg.use_real_data:
            blend["launches"] += _launch_counts()["K1"] - before
            blend["calls"] += 1
        return out

    demo.train_fold, demo.evaluate = checked_fold, counted_evaluate
    t0 = time.perf_counter()
    with _quiet(log_path):
        out = demo.run(demo.parse_args(
            ["--params", PHASE3, "--dir", az, "--steps", "10", "--steps2", "20", "--fanout", "16",
             "--rounds", "2", "--out", os.path.join(CAMPAIGN_OUT, "real_data_demo")]), ModelConfig())
    secs = time.perf_counter() - t0
    arm1 = [f for f in folds if f["trainable"] == ("real_data_linear",)]
    arm2 = [f for f in folds if f["trainable"] != ("real_data_linear",)]
    log(f"[campaign] (e) torch_real_data_demo, 5 stand-in records in the AZ format, full width "
        f"from phase3, bf16, 10 + 20 steps a fold, fan-out 16, 2 rounds: arm 1 folds "
        f"{[round(f['seconds'], 2) for f in arm1]} s, {arm1[0]['frozen_equal']} of "
        f"{arm1[0]['frozen_equal'] + arm1[0]['n_picked']} tensors bit-equal to phase3 (all but "
        f"{arm1[0]['tops']}); arm 2 folds "
        f"{[round(f['seconds'], 2) for f in arm2]} s, moved only {arm2[0]['tops']} "
        f"({arm2[0]['moved']} of {arm2[0]['n_picked']} tensors moved, {arm2[0]['frozen_equal']} "
        f"frozen bit-equal); K1 launches under the blend {blend['launches']} in "
        f"{blend['calls']} evaluations; measured sigma 13C "
        f"{out['real_data_decoder']['sigma_13c_ppm']:.3f} / 1H "
        f"{out['real_data_decoder']['sigma_1h_ppm']:.4f} ppm; {secs:.2f} s in all; {card}")
    if len(arm1) != 5 or len(arm2) != 5 or blend["calls"] != 10 or blend["launches"] <= 0:
        raise AssertionError(f"{len(arm1)} + {len(arm2)} folds, {blend} through the blend")
    if any(f["tops"] != ["real_data_linear"] or f["moved"] != f["n_picked"] for f in arm1):
        raise AssertionError("an arm-1 fold trained more than real_data_linear, or not all of it")
    if any(f["tops"] != ["decoder", "fc_out", "real_data_linear"] or f["moved"] == 0 for f in arm2):
        raise AssertionError("an arm-2 fold trained other tensors than decoder, fc_out and "
                             "real_data_linear")


def campaign_host_tools(card: str, ref_dir: str, log_path: str) -> None:
    """(f): ``torch_chemotype_stats`` and ``torch_make_r3_corpus`` (slabs cut)
    on this machine, which has no JAX."""
    stats = _load_file(os.path.join("scripts", "torch_chemotype_stats.py"))
    r3 = _load_file(os.path.join("scripts", "torch_make_r3_corpus.py"))
    r3.SLABS = ((2000, 21, 80.0, 550.0), (500, 31, 80.0, 250.0), (500, 32, 250.0, 350.0))
    out = os.path.join(CAMPAIGN_OUT, "corpora")
    r3_txt = os.path.join(out, "corpus_r3_cut.txt")
    t0 = time.perf_counter()
    with _quiet(log_path):
        rc_r3 = r3.main(["--out", r3_txt])
    t1 = time.perf_counter()
    with open(r3_txt) as f:
        n_r3 = len(f.read().split())
    with _quiet(log_path):
        rc_stats = stats.main(["--corpus", r3_txt, "--sample", "1000", "--extra",
                               os.path.join(out, "zinclike.txt"), "--ref-dir", ref_dir])
    t2 = time.perf_counter()
    log(f"[campaign] (f) torch_make_r3_corpus with slabs of 2000/500/500: {n_r3} molecules in "
        f"{t1 - t0:.2f} s; torch_chemotype_stats on it and the zinclike corpus: {t2 - t1:.2f} s "
        f"(the table in {log_path}); {card}")
    if rc_r3 != 0 or rc_stats != 0 or not 2000 < n_r3 <= 3000:
        raise AssertionError("the host tools failed")


def campaign_phase(dev, card: str) -> None:
    """Phase 12 (see the module docstring)."""
    import shutil

    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.sim import distill

    t_phase = time.perf_counter()
    shutil.rmtree(CAMPAIGN_OUT, ignore_errors=True)
    os.makedirs(CAMPAIGN_OUT)
    log_path = os.path.join(CAMPAIGN_OUT, "campaign.log")
    committed = {d: sha256_files(d) for d in (distill.WEIGHTS_DIR, SGNN_WEIGHTS)}
    ref_dir = os.path.join(CAMPAIGN_OUT, "ref")
    t0 = time.perf_counter()
    chc, h1 = campaign_testset(dev, ref_dir)
    halves = [sum(dp.ref_testset_split(r.sample_id) == "adapt" for r in recs) for recs in (chc, h1)]
    log(f"[campaign] (a) a stand-in for the shipped test set, NOT the reference's data (no "
        f"figure of this phase measures accuracy on it): {len(chc)} molecules with 13C/HSQC/COSY "
        f"and {len(h1)} with 1H from random_corpus(192, 250-350 Da), simulated on the card by "
        f"the committed shift weights scaled by 1.1, in {time.perf_counter() - t0:.2f} s; adapt "
        f"halves {halves[0]} and {halves[1]}")
    weights = campaign_adapt(dev, card, ref_dir, log_path)
    campaign_corpora(dev, card, ref_dir, weights, log_path)
    torch.cuda.empty_cache()
    campaign_control(dev, card, ref_dir, weights, log_path)
    campaign_real_data(dev, card, chc, log_path)
    campaign_host_tools(card, ref_dir, log_path)
    if {d: sha256_files(d) for d in committed} != committed:
        raise AssertionError("the phase changed the committed simulator weights")
    log(f"[campaign] the phase took {time.perf_counter() - t_phase:.1f} s (the scripts' own "
        f"output: {log_path})")


# ---------------------------------------------------------------------------
# phase 13: the headline bench and the roofline report ("bench")
# ---------------------------------------------------------------------------

BENCH_OUT = os.path.join("chiprun_out", "bench")
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
BENCH_LAUNCHES_K3 = 128 * 6  # a beam call: 128 steps x 6 decoder layers
DETAIL = "[bench] detail "


def _bench_run(cmd: list, env_extra: dict, log_path: str, keys: list) -> tuple[dict, dict]:
    """``cmd`` in a subprocess, with no BENCH_* variable of this process and
    ``env_extra``; checks that its stdout is exactly one JSON line with
    ``keys``, ``unit`` mols/sec/chip and ``value`` the molecules over the
    best rep of its stderr; returns the line and the bench's detail."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run(cmd, env={**env, **env_extra}, capture_output=True, text=True,
                          timeout=900)
    with open(log_path, "a") as f:
        f.write(f"$ {' '.join(f'{k}={v}' for k, v in env_extra.items())} {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}\n")
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"{' '.join(cmd)} printed {len(lines)} lines on stdout: {proc.stdout}")
    line = json.loads(lines[0])
    detail = json.loads([ln for ln in proc.stderr.splitlines() if ln.startswith(DETAIL)][-1]
                        [len(DETAIL):])
    n, best = detail["n"], min(detail["reps_s"])
    if list(line) != keys or line["unit"] != "mols/sec/chip" or line["value"] != round(n / best, 3):
        raise AssertionError(f"the line {line} is not bench.py's, or not {n} molecules over "
                             f"{best!r} s")
    return line, detail


def _bench_log(label: str, line: dict, detail: dict) -> None:
    stages = " ".join(f"{k}={v:.3f}" for k, v in detail["stage_seconds"].items())
    reps = ", ".join(f"{t:.4f}" for t in detail["reps_s"])
    launches = "; ".join(" ".join(f"{k}={v}" for k, v in c.items()) for c in detail["launches"])
    log(f"[bench] {label}: {json.dumps(line)}")
    log(f"[bench] {label}: reps {reps} s; best rep's stage seconds: {stages}; launches a rep: "
        f"{launches}; max_memory_allocated {detail['max_memory_allocated'] / 2**30:.3f} GiB")


def bench_phase(card: str) -> None:
    """Phase 13 (see the module docstring)."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(BENCH_OUT, ignore_errors=True)
    os.makedirs(BENCH_OUT)
    log_path = os.path.join(BENCH_OUT, "bench.log")
    py = sys.executable

    line, detail = _bench_run([py, "bench_torch.py"], {}, log_path,
                              BENCH_KEYS + ["mols_per_sec_mean"])
    _bench_log("e2e", line, detail)
    if (detail["n"] != 48 or "mmt_r4_phase3" not in line["metric"]
            or "trained CLIP" not in line["metric"]):
        raise AssertionError("the e2e bench did not run 48 molecules with phase3 and clip_r4")
    if not all(c["K1"] > 0 and c["K2"] > 0 for c in detail["launches"]):
        raise AssertionError(f"an e2e rep launched K1 or K2 no time: {detail['launches']}")

    for label, cmd, n in (
            ("beam", [py, "bench_torch.py"], 128),
            ("cli bench --batch 16", [py, "-m", "multimodalspectraltransformer_torch.cli", "bench",
                                      "--batch", "16"], 16)):
        line, detail = _bench_run(cmd, {"BENCH_MODE": "beam"}, log_path, BENCH_KEYS)
        _bench_log(label, line, detail)
        if detail["n"] != n or any(c["K3"] != BENCH_LAUNCHES_K3 for c in detail["launches"]):
            raise AssertionError(f"{label}: {detail['n']} molecules, K3 launches "
                                 f"{[c['K3'] for c in detail['launches']]} (want {n}, "
                                 f"{BENCH_LAUNCHES_K3} a call)")

    proc = subprocess.run([py, os.path.join("scripts", "torch_roofline_report.py")],
                          capture_output=True, text=True, timeout=900)
    with open(log_path, "a") as f:
        f.write(f"$ scripts/torch_roofline_report.py\n{proc.stderr}{proc.stdout}\n")
    if proc.returncode != 0:
        raise AssertionError(f"torch_roofline_report.py exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    for row in ("train_step", "mns_decode"):
        r = report[row]
        shares = (r["flops"] / r["wall_s"] / BF16_FLOPS,
                  r["hbm_bytes"] / r["wall_s"] / HBM_BYTES_PER_S)
        if not all(0 < x <= 1.05 for x in shares):
            raise AssertionError(f"roofline {row}: shares {shares} outside (0, 1.05]")
        log(f"[bench] roofline {row}: {json.dumps(r)}")
    for sentence in report["sentences"]:
        log(f"[bench] roofline: {sentence} ({report['card']})")
    log(f"[bench] phase took {time.perf_counter() - t_phase:.1f} s (the benches' own output: "
        f"{log_path})")


# ---------------------------------------------------------------------------
# phase 14: reproducible training
# ---------------------------------------------------------------------------

REPRO_RUNS = {"mmt": 40, "clip": 10, "blip": 10, "shift": 10, "ir": 10}
# E1 launches a train step: the MMT's MF, target-token and position tables;
# the CLIP text tower's word and position tables (BLIP's text tower is one);
# the simulators' GNNs have no lookup table
E1_A_STEP = {"mmt": 3, "clip": 2, "blip": 2, "shift": 0, "ir": 0}
REPRO_OUT = os.path.join("chiprun_out", "determinism")


def repro_phase(dev, card: str, phase6_records) -> None:
    """Phase 14 (see the module docstring)."""
    import torch

    from multimodalspectraltransformer_torch.ops import embedding_grad as e1

    t_phase = time.perf_counter()
    det = _load_file(os.path.join("scripts", "torch_train_determinism.py"))
    os.makedirs(REPRO_OUT, exist_ok=True)
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("phase 14 must run under PyTorch's default algorithms")
    failed = []
    for trainer, reps in REPRO_RUNS.items():
        batch, steps = det.RECIPES[trainer]
        e1.reset_launches()
        rows = det.trainer_runs(trainer, dev, reps, 0, records=phase6_records)
        launches = e1.launches
        with open(os.path.join(REPRO_OUT, f"{trainer}.json"), "w") as f:
            json.dump(rows, f, indent=1)
        bad = [r for r in rows if det.differs(r)]
        for r in bad:
            log(f"[repro] {trainer} run {r['rep']} differs from the first: losses "
                f"{'equal' if r['losses_equal'] else 'differ'}, first gradient difference "
                f"{r['first_gradient_difference']}, at the end {r['tensors_differ']}")
        log(f"[repro] {trainer}: {len(bad)} of {len(rows)} runs of {steps} steps at batch {batch} "
            f"differ from the first under PyTorch's default algorithms; final loss "
            f"{rows[0]['final_loss']:.6f}; E1 launched {launches} times "
            f"({launches / (len(rows) * steps):g} a step); "
            f"{sum(r['secs'] for r in rows) / len(rows):.2f} s a run")
        if bad or len(rows) != reps or launches != E1_A_STEP[trainer] * reps * steps:
            failed.append(trainer)

    cmd = [sys.executable, os.path.join("scripts", "torch_train_determinism.py"), "--step-times",
           "--out", os.path.join(REPRO_OUT, "step_times.json")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    with open(os.path.join(REPRO_OUT, "step_times.log"), "w") as f:
        f.write(f"$ {' '.join(cmd)}\n{proc.stderr}{proc.stdout}\n")
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr[-3000:]}")
    times = json.loads(proc.stdout.splitlines()[-1])
    for trainer in ("mmt", "clip", "blip"):
        t = times[trainer]
        log(f"[repro] {trainer} step at batch {t['batch']} (median of 12 after 3 warm-up, one "
            f"step of each way in turn): {t['today_ms']:.3f} ms with the former lookups, "
            f"{t['e1_ms']:.3f} ms through E1 ({t['e1_launches_a_step']} launches a step), "
            f"{t['switch_ms']:.3f} ms with the former lookups under "
            f"torch.use_deterministic_algorithms; {card}")
        if t["e1_launches_a_step"] != E1_A_STEP[trainer]:
            failed.append(f"{trainer} step times")
    log(f"[repro] the phase took {time.perf_counter() - t_phase:.1f} s (runs and step times under "
        f"{REPRO_OUT}/)")
    if failed:
        raise AssertionError(f"training is not reproducible run to run, or E1 did not launch as "
                             f"expected: {failed}")


def require_simulator_weights(dev) -> None:
    """Fail unless the simulator's GNN weights load: without them
    ``simulate_records`` falls back to the rule teachers (as the JAX package
    does), and every phase would run on other spectra."""
    from multimodalspectraltransformer_torch.sim import distill, factory

    missing = [name for name, loaded in (("shift", factory.default_shift_model(dev)),
                                         ("IR", factory.default_ir_model(dev))) if loaded is None]
    if missing:
        raise RuntimeError(f"the simulator's {' and '.join(missing)} GNN weights are missing: "
                           f"{distill.WEIGHTS_DIR} must hold nmr_shift.msgpack, nmr_shift.json, "
                           f"ir.msgpack and ir.json")


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--save-hsqc", metavar="PATH",
                    help="also save the main path's HSQC cost tensor there (torch.save), for "
                         "scripts/torch_kernel_times.py")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch

    # fails here, before any output, where the rest of the repository is absent
    from multimodalspectraltransformer_torch import native
    from multimodalspectraltransformer_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = gpu_name_and_power()
    log(f"[device] {kind} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {card}")
    require_simulator_weights(dev)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ builds the host library while nvcc runs
        host_lib = pool.submit(native.available)
        lib_path = _build.build(force=True, verbose=True)
        log(f"[build] CUDA kernels: {time.perf_counter() - t0:.2f} s (one nvcc call) -> {lib_path}")
        ok = host_lib.result()
    log(f"[build] host chemistry library: available={ok}, both built in "
        f"{time.perf_counter() - t0:.2f} s")

    k1_row = check_k1(dev)
    check_k2(dev)
    k3_row = check_k3(dev)
    e1_row = check_e1(dev)
    launches, hsqc_cost, (records, model, dcfg, results) = main_path(dev)
    launches["K3"] = beam_path(dev, model, records, dcfg, results)
    phase6_records, launches["E1"] = train_phase(dev, card)
    serve_phase(dev, card)
    contrastive_phase(dev, card, phase6_records, (records, model, dcfg))
    tools_phase(dev, card, phase6_records, (records, model, dcfg))
    torch.cuda.empty_cache()  # the ranks of phase 10 share this card
    parallel_phase(dev, card, phase6_records, (records, model, dcfg))
    torch.cuda.empty_cache()
    drivers_phase(dev, card)
    torch.cuda.empty_cache()
    campaign_phase(dev, card)
    torch.cuda.empty_cache()  # the benches run in processes of their own on this card
    bench_phase(card)
    torch.cuda.empty_cache()
    repro_phase(dev, card, phase6_records)
    if args.save_hsqc:
        torch.save(hsqc_cost.cpu(), args.save_hsqc)

    k2_row = measure_k2(hsqc_cost, f"main-path HSQC cost B={hsqc_cost.shape[0]} "
                        f"N={hsqc_cost.shape[1]}", timed=True)
    kernels = [
        dict(name="decode_attention", route="cuda", source=K1_SOURCE, replaces=K1_REPLACES,
             launches=launches["K1"], **k1_row),
        dict(name="auction", route="cuda", source=K2_SOURCE, replaces=K2_REPLACES,
             launches=launches["K2"], **k2_row),
        dict(name="beam_attention", route="cuda", source=K3_SOURCE, replaces=K3_REPLACES,
             launches=launches["K3"], **k3_row),
        dict(name="embedding_grad", route="cuda", source=E1_SOURCE, replaces=E1_REPLACES,
             launches=launches["E1"], **e1_row),
    ]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
