"""Kernel K2: batched eps-scaled forward auction, [B, N, N] cost -> [B] total.

``auction_assignment_cost(cost)`` returns each problem's total
optimal-assignment cost, within N * eps of the Hungarian optimum, eps being
the last phase's, max(eps_final, eps0 / scale_factor**(n_phases - 1)). It is
the device spectral scorer of the harness (``rank/matching.py``) and replaces
the JAX package's Pallas kernel ``ops/auction.py::auction_assignment_cost_pallas``,
with the same schedule: ``n_phases`` phases, eps0 = max(max - min, eps_final)/2
divided by ``scale_factor`` per phase, at most ``iters_per_phase`` rounds per
phase with an early stop once every object is owned, ties to the lowest
index, unowned objects falling back to the diagonal.

One difference, on purpose: the round cap per phase defaults to 64N, not the
Pallas kernel's 8N. At 8N a phase can end with objects unowned, and the
diagonal fallback then returns a total far from the optimum (on uniform random
HSQC-like peaks at N=32, 2 of 80 problems off by 0.07 and 0.24; at N=64, 29
of 480 off by up to 0.8). At 64N every such problem converged, while the mean
rounds per problem rose by under 5%, since converged problems stop early
anyway. ``iters_per_phase=8 * N`` reproduces the Pallas kernel exactly.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/auction.cu``) or raises; on a CPU tensor it runs
``auction_assignment_cost_plain``, the same algorithm in plain PyTorch. The
kernel takes any N up to ``MAX_N`` (11,596, where its bookkeeping fills a
block's shared memory; the Pallas kernel needs the N x N cost in VMEM, which
stops it far below that), in one of three variants that
``auction_variant(N)`` picks: a warp per problem for N <= 32, else a block
per problem with the cost in shared memory while it fits (N <= 238) and in
device memory above that. Each gives the plain version's assignment and its
rounds per problem (``return_iters``).
"""

from __future__ import annotations

import torch

from . import _build

NEG = -3.0e38  # "no bid" sentinel, finite so max/argmax stay well defined
# a block's shared memory on the H100 (227 KB), less the block kernel's 512 static bytes
SMEM_BYTES = 232448 - 512
MAX_N = SMEM_BYTES // 20  # the block variants keep 20 bytes of bookkeeping per row there
ROUNDS_PER_N = 64  # default round cap per phase, in units of N (Pallas: 8)

launches = 0  # kernel launches since the last reset (plain-version calls do not count)


def auction_assignment_cost_plain(
    cost: torch.Tensor,
    n_phases: int = 8,
    iters_per_phase: int = 0,
    eps_final: float = 1e-5,
    scale_factor: float = 6.0,
    return_iters: bool = False,
):
    """Plain PyTorch version of the kernel, vectorized over the batch. A
    converged problem has no unowned bidder, so further rounds leave it
    unchanged: running every problem until the last one converges gives each
    problem exactly its own early-stopped result. With ``return_iters`` also
    returns the bid/assign rounds each problem ran (int64 [B])."""
    cost = cost.float()
    B, N, _ = cost.shape
    iters = iters_per_phase or ROUNDS_PER_N * N
    dev = cost.device
    benefit = -cost
    idx = torch.arange(N, device=dev)
    eps_final_t = torch.tensor(eps_final, dtype=torch.float32, device=dev)
    scale_t = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    span = cost.amax(dim=(1, 2)) - cost.amin(dim=(1, 2))
    eps_cur = torch.maximum(span, eps_final_t) * 0.5  # [B]
    prices = torch.zeros(B, N, dtype=torch.float32, device=dev)
    owner = torch.full((B, N), -1, dtype=torch.long, device=dev)
    rounds = torch.zeros(B, dtype=torch.long, device=dev)
    for _ in range(n_phases):
        eps = torch.maximum(eps_final_t, eps_cur)
        owner = torch.full((B, N), -1, dtype=torch.long, device=dev)
        for _ in range(iters):
            live = (owner < 0).any(dim=1)  # [B]
            if not bool(live.any()):
                break
            rounds += live.long()
            value = benefit - prices[:, None, :]  # [B, i, j]
            top1, best_j = value.max(dim=2)  # first index on ties
            chosen = idx[None, None, :] == best_j[:, :, None]
            top2 = value.masked_fill(chosen, NEG).amax(dim=2)
            owns = (owner[:, None, :] == idx[None, :, None]).any(dim=2)  # [B, i]
            bid_amount = top1 - top2 + eps[:, None]
            bids = torch.where(~owns[:, :, None] & chosen, bid_amount[:, :, None],
                               torch.full_like(value, NEG))
            win_bid, win_bidder = bids.max(dim=1)  # [B, j], first index on ties
            has_bid = win_bid > NEG / 2
            prices = torch.where(has_bid, prices + win_bid, prices)
            owner = torch.where(has_bid, win_bidder, owner)
        eps_cur = eps / scale_t
    owner = torch.where(owner >= 0, owner, idx[None, :])
    # sum_j cost[owner_j, j], summed in float64 as the kernel does, so the
    # total does not depend on the order of the sum
    total = cost.gather(1, owner[:, None, :])[:, 0, :].double().sum(dim=1).float()
    return (total, rounds) if return_iters else total


def auction_variant(n: int) -> int:
    """The kernel variant for problems of size ``n``: 0 = one warp per problem
    (n <= 32), 1 = one block per problem with the cost in shared memory,
    2 = one block per problem with the cost in device memory (L2-resident).
    Raises above ``MAX_N``."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"auction: N={n} outside 1..{MAX_N}")
    if n <= 32:
        return 0
    return 1 if 20 * n + 4 * n * n <= SMEM_BYTES else 2


def auction_assignment_cost(
    cost: torch.Tensor,
    n_phases: int = 8,
    iters_per_phase: int = 0,
    eps_final: float = 1e-5,
    scale_factor: float = 6.0,
    return_iters: bool = False,
):
    """[B] float32 totals (and with ``return_iters`` the int64 [B] rounds each
    problem ran); kernel on CUDA, plain version on the CPU."""
    global launches
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"auction: cost must be [B, N, N], got {tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"auction: cost must be float32, got {cost.dtype}")
    if cost.device.type == "cpu":
        return auction_assignment_cost_plain(cost, n_phases, iters_per_phase, eps_final,
                                             scale_factor, return_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"auction: unsupported device {cost.device}")
    if not cost.is_contiguous():
        raise ValueError("auction: cost must be contiguous")
    B, N, _ = cost.shape
    variant = auction_variant(N)
    total = torch.empty(B, dtype=torch.float32, device=cost.device)
    rounds = torch.empty(B, dtype=torch.int32, device=cost.device) if return_iters else None
    if B > 0:
        err = _build.lib().mmt_auction(
            cost.data_ptr(), total.data_ptr(), None if rounds is None else rounds.data_ptr(), B, N,
            n_phases, iters_per_phase or ROUNDS_PER_N * N, eps_final, scale_factor, variant,
            _build.stream_ptr(cost.device))
        _build.check(err, "mmt_auction")
        launches += 1
    return (total, rounds.long()) if return_iters else total


def reset_launches() -> None:
    global launches
    launches = 0
