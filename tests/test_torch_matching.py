"""Kernel K2's plain version and the device spectral scorer against the JAX
package and scipy.

- With the Pallas round cap (``iters_per_phase=8N``) the port's auction is the
  Pallas kernel's function: same totals as ``auction_assignment_cost_pallas``
  in interpret mode (1e-5: float32 sums in another order).
- With the port's default cap (64N) it is within N * eps_last of scipy's
  optimum on every problem, including those where the Pallas cap stops a phase
  early and its diagonal fallback misses the optimum (logged in ROADMAP.md,
  "Faults found").
- ``batched_pairwise_assignment_error`` against scipy on the same padded
  problems and against the JAX scorer, which off the TPU uses a different
  auction; both are held to scipy, not to each other bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import kernel_timing as kt
from multimodalspectraltransformer_torch.ops import auction as tk2
from multimodalspectraltransformer_torch.rank import matching as tm
from multimodalspectraltransformer_tpu.ops import auction as jk2
from multimodalspectraltransformer_tpu.rank import matching as jm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(costs: np.ndarray) -> np.ndarray:
    return np.array([c[linear_sum_assignment(c)].sum() for c in costs.astype(np.float64)])


def _eps_last(costs: np.ndarray) -> np.ndarray:
    span = costs.max(axis=(1, 2)) - costs.min(axis=(1, 2))
    return np.maximum(1e-5, np.maximum(span, 1e-5) * 0.5 / 6.0**7)


def _peaks(rng, n_pairs: int, n_max: int):
    qs, cs = [], []
    for _ in range(n_pairs):
        nq, nc = rng.integers(max(1, n_max // 2), n_max + 1, size=2)
        qs.append(np.column_stack([rng.uniform(0, 10, nq), rng.uniform(0, 200, nq)]))
        cs.append(np.column_stack([rng.uniform(0, 10, nc), rng.uniform(0, 200, nc)]))
    return qs, cs


@pytest.mark.parametrize("case", ["uniform16", "ties", "zero_block", "harness8"])
def test_auction_plain_is_the_pallas_function(case, record_property):
    """The plain version's totals against the Pallas kernel in interpret
    mode, at the Pallas round cap; the largest difference is recorded as the
    ``max_abs_diff_vs_pallas`` property of the JUnit report."""
    rng = np.random.default_rng(1)
    if case == "uniform16":
        costs = rng.random((6, 16, 16)).astype(np.float32)
    elif case == "ties":
        costs = rng.random((3, 8, 8)).astype(np.float32)
        costs[:, 2] = costs[:, 1]  # duplicate rows
        costs[:, :, 5] = costs[:, :, 4]  # duplicate columns
    elif case == "zero_block":
        costs = np.zeros((2, 8, 8), np.float32)
        costs[:, :4, :4] = rng.random((2, 4, 4))
    else:
        costs = tm.pairwise_cost(*_peaks(rng, 6, 8), device="cpu")[0].numpy()
    N = costs.shape[1]
    ref = np.asarray(jk2.auction_assignment_cost_pallas(costs, interpret=True))
    ours = tk2.auction_assignment_cost(torch.from_numpy(costs), iters_per_phase=8 * N).numpy()
    record_property("max_abs_diff_vs_pallas", float(np.abs(ours - ref).max()))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours, _opt(costs), atol=N * 1e-4)


def test_auction_default_cap_converges_where_pallas_stops_early():
    """Uniform random HSQC-like peaks at N=32: with the Pallas cap some
    problems end a phase unconverged and miss the optimum by far more than
    N * eps; the port's default cap solves every one within it."""
    rng = np.random.default_rng(0)
    _peaks(rng, 80, 8)
    cost = tm.pairwise_cost(*_peaks(rng, 80, 32), device="cpu")[0]
    c = cost.numpy()
    opt, tol = _opt(c), cost.shape[1] * _eps_last(c) + 1e-4
    capped = tk2.auction_assignment_cost_plain(cost, iters_per_phase=8 * 32).numpy()
    assert np.sum(capped - opt > tol) >= 1  # the Pallas schedule's miss
    ours = tk2.auction_assignment_cost(cost).numpy()
    assert np.all(ours - opt <= tol) and np.all(ours - opt >= -1e-4)


def test_auction_plain_solves_sizes_above_the_old_kernel_limit():
    """N = 240 (the card runs it from device memory, past the 224 the kernel
    once refused): the plain version within N * eps_last of scipy's optimum,
    on uniform costs with tied rows and columns."""
    rng = np.random.default_rng(240)
    costs = rng.random((1, 240, 240)).astype(np.float32)
    costs[:, 2] = costs[:, 1]
    costs[:, :, 5] = costs[:, :, 4]
    ours, rounds = tk2.auction_assignment_cost_plain(torch.from_numpy(costs), return_iters=True)
    gap = ours.numpy() - _opt(costs)
    assert np.all(gap <= 240 * _eps_last(costs) + 1e-4) and np.all(gap >= -1e-4)
    assert int(rounds[0]) > 0


@pytest.mark.parametrize("n, variant", [(1, 0), (8, 0), (32, 0), (33, 1), (64, 1), (224, 1),
                                        (238, 1), (239, 2), (300, 2), (tk2.MAX_N, 2)])
def test_auction_variant_by_size(n, variant):
    """The kernel variant the wrapper picks: a warp per problem up to 32, a
    block with the cost in shared memory while 20N + 4N^2 bytes fit in 227 KB
    (N <= 238), a block reading the cost from device memory above that."""
    assert tk2.auction_variant(n) == variant


def test_auction_timed_shapes_cover_both_block_variants():
    """The K2 shapes that chip_smoke.py and scripts/torch_kernel_times.py
    time (kernel_timing.K2_TIMED) lie on each side of N = 238, so both block
    variants keep a timed shape."""
    assert {tk2.auction_variant(n) for _, _, n in kt.K2_TIMED} == {1, 2}


@pytest.mark.parametrize("n", [0, tk2.MAX_N + 1])
def test_auction_variant_refuses_sizes_no_variant_takes(n):
    with pytest.raises(ValueError):
        tk2.auction_variant(n)


def test_auction_wrapper_returns_rounds_on_cpu():
    """``return_iters`` through the wrapper gives the plain version's rounds."""
    cost = torch.from_numpy(np.random.default_rng(3).random((4, 12, 12)).astype(np.float32))
    total, rounds = tk2.auction_assignment_cost(cost, return_iters=True)
    ref, ref_rounds = tk2.auction_assignment_cost_plain(cost, return_iters=True)
    assert torch.equal(total, ref) and torch.equal(rounds, ref_rounds)
    assert rounds.dtype == torch.int64 and bool((rounds > 0).all())


@pytest.mark.parametrize("n_max", [8, 24])
def test_batched_pairwise_assignment_error_matches_scipy_and_jax(n_max):
    rng = np.random.default_rng(n_max)
    qs, cs = _peaks(rng, 12, n_max)
    cs[0] = cs[0][:1]  # a very uneven pair
    ours = tm.batched_pairwise_assignment_error(qs, cs, device="cpu")
    theirs = np.asarray(jm.batched_pairwise_assignment_error(qs, cs))
    cost, denom = tm.pairwise_cost(qs, cs, device="cpu")
    c = cost.numpy()
    ref = _opt(c) / denom
    tol = (cost.shape[1] * _eps_last(c) + 1e-4) / denom
    assert ours.shape == (12,) and theirs.shape == (12,)
    assert np.all(np.abs(ours - ref) <= tol)
    assert np.all(np.abs(theirs - ref) <= cost.shape[1] * 1e-4 / denom + 1e-4)
    # hung_dist_zero semantics: equal to the host engine's mode on each pair
    host = np.array([jm.spectral_error(q, c_, "hung_dist_zero") for q, c_ in zip(qs, cs)])
    np.testing.assert_allclose(ours, host, atol=1e-3)


def test_pairwise_cost_layout():
    q = [np.array([[1.0, 50.0], [2.0, 60.0]])]
    c = [np.array([[1.0, 50.0]])]
    cost, denom = tm.pairwise_cost(q, c, device="cpu")
    assert cost.shape == (1, 8, 8) and cost.dtype == torch.float32 and denom.tolist() == [2]
    assert float(cost[0, 0, 0]) == 0.0  # identical peaks
    assert float(cost[0, 0, 2]) == tm.BIG_M  # real row vs excess column
    assert float(cost[0, 5, 6]) == 0.0  # excess pairs with excess


def test_host_engine_is_the_jax_engine():
    rng = np.random.default_rng(5)
    for _ in range(3):
        a = rng.uniform(0, 10, (7, 2)) * [1, 20]
        b = rng.uniform(0, 10, (4, 2)) * [1, 20]
        np.testing.assert_array_equal(tm.all_mode_errors(a, b), jm.all_mode_errors(a, b))


