"""Timers and the timed shapes of the port's kernels K1, K2, K3 and E1.

``chip_smoke.py`` and ``scripts/torch_kernel_times.py`` both time the shapes
listed here with the timers here, so the smoke run and a comparison of two
commits measure the same inputs. The module imports torch only: the kernels
and the functions that build their inputs come from the caller, so a script
can time the package of another tree (``--pkg-root``) with them.

- ``graph_ms``: cold device time per launch, one CUDA-graph replay of
  launches over enough copies of the inputs that one pass exceeds the L2;
- ``cuda_ms``: eager time per call, which includes the host's enqueue;
- ``k1_cases``, ``k2_cases``, ``k3_cases``, ``e1_cases``: the timed inputs,
  from seeds.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

L2_BYTES = 50e6  # H100 L2 cache

K1_TIMED = ((1024, torch.float32), (1024, torch.bfloat16), (6144, torch.float32),
            (6144, torch.bfloat16))  # (lanes, dtype): H=16, Dh=8, T=128, pos 63
K2_TIMED = (("HSQC-like", 480, 64), ("uniform", 48, 160), ("uniform", 8, 300))  # (kind, B, N)
K3_TIMED = ((128, 5), (32, 10))  # (B, K): H=16, Dh=8, T=128 at pos 0, 63, 127, fp32 and bf16
K3_POSITIONS = (0, 63, 127)
# (table, V, D, ids [rows, cols], gradient dtype, draw): the trained lookup
# tables at their training batches. A float draw p: padding id 0 with
# probability p, else uniform; "arange": the decoder's positions; "roberta":
# the CLIP text tower's position ids (0 on padding, 1.. on the tokens)
E1_TIMED = (("MMT embed_trg", 43, 128, (64, 63), torch.bfloat16, 0.5),
            ("MMT pe_trg", 128, 128, (1, 63), torch.bfloat16, "arange"),
            ("MMT MF", 213, 128, (64, 64), torch.bfloat16, 0.85),
            ("CLIP word", 600, 768, (256, 64), torch.float32, 0.5),
            ("CLIP position", 130, 768, (256, 64), torch.float32, "roberta"),
            ("Q-Former word", 43, 768, (32, 64), torch.float32, 0.5))


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per eager call, CUDA events around ``reps`` calls on
    warm inputs. Below about 0.02 ms this is the host's enqueue rate (Python,
    ``torch.empty`` and the ``ctypes`` launch), not the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(make_call, inputs: tuple, reps: int):
    """A CUDA graph of ``max(reps, copies)`` launches of ``make_call`` over
    ``copies`` distinct copies of ``inputs`` (round-robin), enough that one
    pass over them is three times the 50 MB L2: every launch finds its
    inputs cold, as a real decode does. Returns (graph, launches)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = max(2, math.ceil(3 * L2_BYTES / nbytes))
    sets = [inputs] + [tuple(t.clone() for t in inputs) for _ in range(copies - 1)]
    reps = max(reps, copies)
    make_call(*inputs)  # the library is loaded and every attribute set before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            make_call(*sets[i % copies])
    graph.replay()  # warm-up
    torch.cuda.synchronize()
    return graph, reps


def graph_ms(make_call, inputs: tuple, reps: int) -> float:
    """Cold device milliseconds per launch: one replay of ``capture``'s
    graph between CUDA events, over its launch count. No host time enters."""
    graph, n = capture(make_call, inputs, reps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profiler_ms(make_call, inputs: tuple, reps: int, kernel: str) -> Optional[float]:
    """The same replay under torch.profiler: mean device time of the CUDA
    kernels whose name holds ``kernel``, or None if the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

    graph, _ = capture(make_call, inputs, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    times = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type.name == "CUDA" and kernel in e.name]
    return sum(times) / len(times) / 1e3 if times else None


def peak_lists(rng, n_pairs: int, n_max: int):
    """Random (query, candidate) HSQC-like peak lists in ppm, sizes up to n_max."""
    qs, cs = [], []
    for _ in range(n_pairs):
        nq, nc = rng.integers(max(1, n_max // 2), n_max + 1, size=2)
        qs.append(np.column_stack([rng.uniform(0, 10, nq), rng.uniform(0, 200, nq)]))
        cs.append(np.column_stack([rng.uniform(0, 10, nc), rng.uniform(0, 200, nc)]))
    return qs, cs


def edge_costs(rng, B: int, N: int) -> np.ndarray:
    """[B, N, N] float32 uniform costs with two tied rows and two tied
    columns in every problem (where N allows), and a constant block in the
    last."""
    cost = rng.random((B, N, N)).astype(np.float32)
    if N > 5:
        cost[:, 2] = cost[:, 1]
        cost[:, :, 5] = cost[:, :, 4]
    cost[-1, N // 2 :, N // 2 :] = 0.5
    return cost


def ancestry_bias(ancestry_bias_fn, gen, B: int, K: int, T: int, pos: int, dtype, dev):
    """The beam step's bias [B, K, T*K] from a random ancestry up to ``pos``,
    built by the package's ``decode.functional.ancestry_bias``."""
    anc = torch.randint(0, K, (B, K, T), generator=gen, device=dev)
    anc[:, :, pos + 1 :] = torch.arange(K, device=dev)[None, :, None]
    return ancestry_bias_fn(anc, pos, dtype)


def k1_cases(dev):
    """(label, q, kv, pos) of K1's timed shapes, from seed 1."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, dtype in K1_TIMED:
        q = (torch.randn(B, 16, 8, generator=gen, device=dev) / 8**0.5).to(dtype)
        kv = torch.randn(B, 16, 16, 128, generator=gen, device=dev).to(dtype)
        yield f"B={B} H=16 Dh=8 {str(dtype)[6:]} pos=63", q, kv, 63


def k2_cases(dev, pairwise_cost):
    """(label, cost) of K2's timed shapes, from seed 0: HSQC-like costs built
    by the package's ``rank.matching.pairwise_cost`` as the scorer builds
    them, and uniform costs with ties at N on each side of 238, where the
    block variant's cost leaves shared memory."""
    rng = np.random.default_rng(0)
    for kind, B, N in K2_TIMED:
        if kind == "HSQC-like":
            cost = pairwise_cost(*peak_lists(rng, B, N), device=dev)[0]
        else:
            cost = torch.from_numpy(edge_costs(rng, B, N)).to(dev)
        yield f"{kind} B={B} N={cost.shape[1]}", cost


def k3_cases(dev, ancestry_bias_fn):
    """(label, q, kv, bias, n_live) of K3's timed shapes, from seed 2: beam
    mode's shape and K=10 at B=32, on a random ancestry."""
    gen = torch.Generator(device=dev).manual_seed(2)
    H, Dh, T = 16, 8, 128
    for B, K in K3_TIMED:
        q32 = torch.randn(B, H, K, Dh, generator=gen, device=dev) / Dh**0.5
        kv32 = torch.randn(B, H, 2 * Dh, T * K, generator=gen, device=dev)
        for pos in K3_POSITIONS:
            bias32 = ancestry_bias(ancestry_bias_fn, gen, B, K, T, pos, torch.float32, dev)
            for dtype in (torch.float32, torch.bfloat16):
                yield (f"B={B} K={K} Dh={Dh} {str(dtype)[6:]} pos={pos}", q32.to(dtype),
                       kv32.to(dtype), bias32.to(dtype), (pos + 1) * K)


def e1_ids(gen, V: int, rows: int, cols: int, draw, dev) -> torch.Tensor:
    """[rows, cols] int64 lookup ids drawn as ``E1_TIMED`` says."""
    if draw == "arange":
        return torch.arange(cols, device=dev).expand(rows, cols).contiguous()
    if draw == "roberta":
        lengths = torch.randint(8, cols + 1, (rows, 1), generator=gen, device=dev)
        mask = (torch.arange(cols, device=dev)[None] < lengths).long()
        return torch.cumsum(mask, dim=1) * mask
    pad = torch.rand(rows, cols, generator=gen, device=dev) < draw
    return torch.where(pad, 0, torch.randint(0, V, (rows, cols), generator=gen, device=dev))


def e1_cases(dev):
    """(label, grad, ids, V) of E1's timed shapes, from seed 4."""
    gen = torch.Generator(device=dev).manual_seed(4)
    for table, V, D, (rows, cols), dtype, draw in E1_TIMED:
        ids = e1_ids(gen, V, rows, cols, draw, dev)
        grad = torch.randn(rows, cols, D, generator=gen, device=dev).to(dtype)
        yield f"{table} V={V} D={D} N={rows * cols} {str(dtype)[6:]}", grad, ids, V
