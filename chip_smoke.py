#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or a few):

1. build   - compiles the CUDA kernels (``csrc/*.cu``, one plain nvcc call)
             and the host chemistry library (g++), printing seconds and paths;
2. kernels - K1 (decode attention), K2 (auction) and K3 (beam attention) on
             the card at their paths' shapes, each held against its plain
             PyTorch version (K2 also against scipy), with times;
3. main    - ``evaluate_molecules`` at the full width of ``ModelConfig()`` with
             the committed phase3 weights on 8 simulated molecules, CLIP off,
             fan-out 128, bf16 decoding; the kernels' launch counters are set
             to 0 just before the run and read just after;
4. check   - the run's outputs: every scored pair against scipy's optimum,
             and the greedy decode on the card (K1) against the CPU's plain
             path at float32, token for token;
5. beam    - (a) beam mode (bench.py's ``BENCH_MODE=beam``): 128 molecules
             with seeded uniform spectra, beam 5, 128 steps without early
             exit, bf16, one warm-up and two timed calls with the counters
             reset before each (K3: 768 launches a call); (b) at float32 on 8
             of those molecules, ``beam_search`` (K3) on the card against
             ``beam_search_materialized`` (K1) on the card and against the
             CPU's plain path, token for token; (c) ``evaluate_molecules`` on
             the 8 molecules of phase 3 with the beam and greedy hypotheses
             in the pools, every gated beam and greedy hypothesis checked to
             be there.

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
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import kernel_timing as kt

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

K1_SOURCE = "multimodalspectraltransformer_torch/csrc/decode_attention.cu"
K1_REPLACES = "multimodalspectraltransformer_tpu/ops/decode_attention.py:49"
K2_SOURCE = "multimodalspectraltransformer_torch/csrc/auction.cu"
K2_REPLACES = "multimodalspectraltransformer_tpu/ops/auction.py:30"
K3_SOURCE = "multimodalspectraltransformer_torch/csrc/beam_attention.cu"
K3_REPLACES = "multimodalspectraltransformer_tpu/ops/beam_attention.py:34"
PHASE3 = "weights/mmt_r4_phase3.msgpack.gz"


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
    from multimodalspectraltransformer_torch.rank import matching
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig

    cfg = ModelConfig()
    t0 = time.perf_counter()
    records = factory.simulate_records(molrandom.random_corpus(2 * n_mols, seed=123)[:n_mols], device=dev)
    model = mmt.load_model(PHASE3, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"[main] set-up: {len(records)} records simulated, phase3 loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    dcfg = DecodeConfig(max_len=64, fanout=fanout, multinom_runs=10, max_temp_rounds=5,
                        compute_dtype="bfloat16")

    t0 = time.perf_counter()
    harness.evaluate_molecules(records, model, dcfg, seed=1, device=dev)  # warm-up
    log(f"[main] warm-up run: {time.perf_counter() - t0:.2f} s")

    k1.reset_launches()
    k2.reset_launches()
    t0 = time.perf_counter()
    results, summary = harness.evaluate_molecules(records, model, dcfg, seed=0, device=dev)
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
    return launches, cost, (records, model, dcfg, results)


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
    launches, hsqc_cost, (records, model, dcfg, results) = main_path(dev)
    launches["K3"] = beam_path(dev, model, records, dcfg, results)
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
    ]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
