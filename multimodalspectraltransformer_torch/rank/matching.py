"""Spectral point-cloud matching: the 9-mode host engine and the device scorer.

The host engine (``normalize_peaks``, ``align``, ``spectral_error``,
``all_mode_errors``) is the JAX package's ``rank/matching.py`` copied as is:
modes {min_sum, euc_dist (greedy NN), hung_dist (Hungarian)} x {zero-pad,
truncate, NN-expand} over 2D peak lists normalized H/10-0.5 and C/200-0.5.

The device scorers solve zero-padded assignments in one call of kernel K2
(``ops/auction.py``): ``batched_pairwise_assignment_error`` every (query,
candidate) pair of the harness, ``batched_assignment_error`` one query
against C candidates.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist
import torch

from ..ops.auction import auction_assignment_cost
from ..utils.device import DeviceLike, resolve_device

MODES = (
    "min_sum_zero",
    "euc_dist_zero",
    "hung_dist_zero",
    "min_sum_trunc",
    "euc_dist_trunc",
    "hung_dist_trunc",
    "min_sum_nn",
    "euc_dist_nn",
    "hung_dist_nn",
)

# reference mode_dict (`models_MMT_v15_4.py:144`)
MODE_INDEX = {
    "MinSum_Zero": 0, "EucDis_Zero": 1, "HungDist_Zero": 2,
    "MinSum_Trunc": 3, "EucDis_Trunc": 4, "HungDist_Trunc": 5,
    "MinSum_NN": 6, "EucDis_NN": 7, "HungDist_NN": 8,
}
_REFERENCE_ORDER_TO_OURS = {
    0: "min_sum_zero", 1: "euc_dist_zero", 2: "hung_dist_zero",
    3: "min_sum_trunc", 4: "euc_dist_trunc", 5: "hung_dist_trunc",
    6: "min_sum_nn", 7: "euc_dist_nn", 8: "hung_dist_nn",
}


def normalize_peaks(points: np.ndarray) -> np.ndarray:
    """[N, 2] raw (F2 ppm, F1 ppm) -> normalized (H/10-0.5, C/200-0.5)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    out = np.empty_like(pts)
    out[:, 0] = pts[:, 0] / 10.0 - 0.5
    out[:, 1] = pts[:, 1] / 200.0 - 0.5
    return out


def _pad_to_max(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n, m = len(a), len(b)
    if n < m:
        a = np.concatenate([a, np.zeros((m - n, 2))], axis=0)
    elif m < n:
        b = np.concatenate([b, np.zeros((n - m, 2))], axis=0)
    return a, b


def _min_sum_sort(a: np.ndarray) -> np.ndarray:
    return a[np.argsort(-(a[:, 0] + a[:, 1]), kind="stable")]


def _greedy_pairs(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Greedy global matching: all pairs sorted by distance, accept a pair
    iff neither endpoint is used (reference euclidean_distance_uneven).
    Returns index arrays (ia, ib) of length min(N, M)."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return np.zeros(0, int), np.zeros(0, int)
    d = cdist(a, b)
    flat = np.argsort(d, axis=None, kind="stable")
    used_a = np.zeros(n, bool)
    used_b = np.zeros(m, bool)
    ia, ib = [], []
    want = min(n, m)
    for f in flat:
        i, j = divmod(int(f), m)
        if used_a[i] or used_b[j]:
            continue
        used_a[i] = used_b[j] = True
        ia.append(i)
        ib.append(j)
        if len(ia) == want:
            break
    return np.asarray(ia, int), np.asarray(ib, int)


def _nn_expand(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Greedy match, then ONE extra greedy round matching the longer set's
    leftovers against the whole shorter set (reference
    euclidean_distance_nn runs exactly one euclidean_distance_uneven pass).
    NOTE: when ||N - M|| > min(N, M) some leftovers stay unmatched — total
    pairs = min(N,M) + min(min(N,M), |N-M|), NOT max(N, M). The avg error
    divides by this aligned-pair count (the reference divides by the
    post-alignment list length, similarity_functions_v15_4.py:572-578)."""
    ia, ib = _greedy_pairs(a, b)
    pa, pb = list(a[ia]), list(b[ib])
    if len(a) < len(b):
        used = set(ib.tolist())
        leftover = np.asarray([j for j in range(len(b)) if j not in used], int)
        if leftover.size:
            ia2, ib2 = _greedy_pairs(a, b[leftover])
            pa.extend(a[ia2])
            pb.extend(b[leftover][ib2])
    elif len(a) > len(b):
        used = set(ia.tolist())
        leftover = np.asarray([i for i in range(len(a)) if i not in used], int)
        if leftover.size:
            ia2, ib2 = _greedy_pairs(a[leftover], b)
            pa.extend(a[leftover][ia2])
            pb.extend(b[ib2])
    return np.asarray(pa), np.asarray(pb)


def _hungarian(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Optimal assignment (reference hungarian_zero_padded, `:735-751`)."""
    c = cdist(a, b)
    ra, rb = linear_sum_assignment(c)
    return a[ra], b[rb]


def _filter_zero_pairs(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop pairs where either point is (0,0) padding. The reference's
    filter_out_zeros (similarity_functions_v15_4.py:754-778) treats any
    point with |x|+|y| < 0.001 as padding — same threshold here, so a real
    peak that normalizes into that ball is (deliberately) dropped too."""
    keep = ~((np.abs(a).sum(axis=1) < 1e-3) | (np.abs(b).sum(axis=1) < 1e-3))
    return a[keep], b[keep]


def align(a: np.ndarray, b: np.ndarray, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """Produce the aligned, equal-length point lists for a mode."""
    if mode == "min_sum_zero":
        a, b = _pad_to_max(a, b)
        return _min_sum_sort(a), _min_sum_sort(b)
    if mode == "min_sum_trunc":
        k = min(len(a), len(b))
        return _min_sum_sort(a)[:k], _min_sum_sort(b)[:k]
    if mode == "min_sum_nn":
        sa, sb = _min_sum_sort(a), _min_sum_sort(b)
        k = min(len(sa), len(sb))
        pa, pb = list(sa[:k]), list(sb[:k])
        if len(sb) > len(sa):
            ia, ib = _greedy_pairs(sa, sb[k:])
            pa.extend(sa[ia]); pb.extend(sb[k:][ib])
        elif len(sa) > len(sb):
            ia, ib = _greedy_pairs(sa[k:], sb)
            pa.extend(sa[k:][ia]); pb.extend(sb[ib])
        return np.asarray(pa), np.asarray(pb)
    if mode == "euc_dist_zero":
        a, b = _pad_to_max(a, b)
        ia, ib = _greedy_pairs(a, b)
        return a[ia], b[ib]
    if mode == "euc_dist_trunc":
        a, b = _pad_to_max(a, b)
        ia, ib = _greedy_pairs(a, b)
        return _filter_zero_pairs(a[ia], b[ib])
    if mode == "euc_dist_nn":
        return _nn_expand(a, b)
    if mode == "hung_dist_zero":
        a, b = _pad_to_max(a, b)
        return _hungarian(a, b)
    if mode == "hung_dist_trunc":
        a, b = _pad_to_max(a, b)
        ia, ib = _greedy_pairs(a, b)
        fa, fb = _filter_zero_pairs(a[ia], b[ib])
        return _hungarian(fa, fb)
    if mode == "hung_dist_nn":
        ea, eb = _nn_expand(a, b)
        return _hungarian(ea, eb)
    raise ValueError(f"unknown mode {mode!r}")


def spectral_error(
    peaks_query: np.ndarray,
    peaks_sim: np.ndarray,
    mode: str = "hung_dist_nn",
    error: str = "avg",
    normalized: bool = False,
) -> float:
    """Error between two raw (F2, F1) ppm peak lists under one mode."""
    a = np.asarray(peaks_query, float).reshape(-1, 2)
    b = np.asarray(peaks_sim, float).reshape(-1, 2)
    if not normalized:
        a, b = normalize_peaks(a), normalize_peaks(b)
    pa, pb = align(a, b, mode)
    if len(pa) == 0:
        return float("nan")
    dists = np.linalg.norm(pa - pb, axis=1)
    total = float(dists.sum())
    if error == "sum":
        return total
    # The reference's avg divides by the POST-alignment list length
    # (similarity_functions_v15_4.py:572-578: max(len) for zero/nn modes,
    # min(len) for trunc — but after alignment both lists are the same
    # length, so every branch reduces to the aligned-pair count). For zero
    # modes that equals max(la, lb); for trunc, min(la, lb); for nn,
    # min + min(min, |la - lb|).
    return total / len(pa)


def all_mode_errors(
    peaks_query: np.ndarray, peaks_sim: np.ndarray, error: str = "avg"
) -> np.ndarray:
    """All 9 modes in the reference's order
    (`get_similarity_comparison_variations`, `similarity_functions:227`)."""
    return np.asarray(
        [spectral_error(peaks_query, peaks_sim, _REFERENCE_ORDER_TO_OURS[i], error) for i in range(9)]
    )


# ---------------------------------------------------------------------------
# Device path: batched optimal assignment through kernel K2
# ---------------------------------------------------------------------------

BIG_M = 10.0  # cost of pairing a real peak with excess padding


def pairwise_cost(queries: "list[np.ndarray]", cands: "list[np.ndarray]",
                  device: DeviceLike = None) -> tuple[torch.Tensor, np.ndarray]:
    """[T, N, N] float32 cost on the device for T (query, candidate) raw peak
    lists, N = max peak count rounded up to a multiple of 8, and the per-pair
    denominators max(nq, nc, 1).

    hung_dist_zero semantics on the uniformly padded square: rows/columns
    beyond a pair's max(nq, nc) are EXCESS padding and may only pair with
    each other (``BIG_M`` against real ones), so real peaks cannot escape to
    surplus zeros; BIG_M > 2 * the largest normalized point distance."""
    dev = resolve_device(device)
    t = len(queries)
    nq = np.asarray([len(q) for q in queries], np.int32)
    nc = np.asarray([len(c) for c in cands], np.int32)
    n = int(max(1, max(nq.max(initial=1), nc.max(initial=1))))
    n = (n + 7) // 8 * 8
    qa = np.zeros((t, n, 2), np.float32)
    ca = np.zeros((t, n, 2), np.float32)
    for i, (q, c) in enumerate(zip(queries, cands)):
        if len(q):
            qa[i, : len(q)] = normalize_peaks(np.asarray(q, float).reshape(-1, 2))
        if len(c):
            ca[i, : len(c)] = normalize_peaks(np.asarray(c, float).reshape(-1, 2))
    qt = torch.from_numpy(qa).to(dev)
    ct = torch.from_numpy(ca).to(dev)
    cost = torch.linalg.vector_norm(qt[:, :, None, :] - ct[:, None, :, :], dim=-1)
    n_active = torch.from_numpy(np.maximum(nq, nc)).to(dev)
    act = torch.arange(n, device=dev)[None, :] < n_active[:, None]  # [T, N]
    cost = cost.masked_fill(act[:, :, None] != act[:, None, :], BIG_M).contiguous()
    return cost, np.maximum(np.maximum(nq, nc), 1)


def batched_pairwise_assignment_error(
    queries: "list[np.ndarray]",  # T raw (F2, F1) ppm peak lists
    cands: "list[np.ndarray]",  # T raw candidate peak lists (row-paired)
    device: DeviceLike = None,
) -> np.ndarray:
    """Average optimal-assignment error of T (query, candidate) pairs in ONE
    kernel call: the harness's production spectral-error scorer
    (hung_dist_zero semantics, divided by max(nq, nc))."""
    if len(queries) == 0:
        return np.zeros(0, np.float32)
    cost, denom = pairwise_cost(queries, cands, device)
    total = auction_assignment_cost(cost)
    return total.cpu().numpy().astype(np.float32) / denom


def batched_assignment_error(
    query: np.ndarray,  # [N, 2] normalized query peaks
    candidates: np.ndarray,  # [C, M, 2] normalized candidate peak sets, zero-padded
    query_count: int,
    cand_counts: np.ndarray,  # [C] true peak counts
    device: DeviceLike = None,
) -> np.ndarray:
    """Average optimal-assignment error of one query against C candidate peak
    sets in one kernel call. Both sides are zero-padded to one square size
    and padding peaks pair up at zero cost (hung_dist_zero)."""
    dev = resolve_device(device)
    C, M, _ = candidates.shape
    n = max(query_count, M)
    q = np.zeros((n, 2), np.float32)
    q[:query_count] = query[:query_count]
    c = np.zeros((C, n, 2), np.float32)
    c[:, :M] = candidates
    qt = torch.from_numpy(q).to(dev)
    ct = torch.from_numpy(c).to(dev)
    cost = torch.linalg.vector_norm(qt[None, :, None, :] - ct[:, None, :, :], dim=-1).contiguous()
    total = auction_assignment_cost(cost)
    return total.cpu().numpy() / np.maximum(np.maximum(query_count, cand_counts), 1)
