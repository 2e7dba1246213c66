"""Batch orders for an epoch.

Counterpart of the JAX package's ``data/samplers.py``, in numpy: a seeded
shuffle, the MW-sorted order shuffled within windows (batches of near-equal
weight, hard negatives for contrastive training) and greedy Tanimoto-anchor
batches. Each returns an epoch-long index order; ``data.pipeline.Loader``
cuts batches from it as contiguous slices. The seeds are the JAX package's,
so the orders are identical.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..chem import api as chem
from ..chem.fingerprint import batch_tanimoto


def shuffled_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(n)


def weight_sorted_order(
    smiles: Sequence[str], batch_size: int, seed: int, epoch: int,
    window_factor: int = 4,
) -> np.ndarray:
    """Sort by MW, then shuffle inside windows of window_factor*batch_size."""
    rng = np.random.default_rng((seed, epoch, 1))
    wts = chem.batch_exact_mol_wt(smiles)
    wts = np.where(np.isnan(wts), np.inf, wts)
    order = np.argsort(wts, kind="stable")
    window = max(batch_size * window_factor, 1)
    for lo in range(0, len(order), window):
        seg = order[lo : lo + window].copy()
        rng.shuffle(seg)
        order[lo : lo + window] = seg
    return order


def tanimoto_anchor_order(
    smiles: Sequence[str], batch_size: int, seed: int, epoch: int,
    n_bits: int = 512,
) -> np.ndarray:
    """Greedy anchor batches: a random unused anchor, then the most
    Tanimoto-similar unused molecules; similarities one anchor row at a time
    (O(n) memory)."""
    n = len(smiles)
    fps, valid = chem.batch_morgan_fp(smiles, n_bits=n_bits)
    rng = np.random.default_rng((seed, epoch, 2))
    unused = np.ones(n, dtype=bool)
    order: list[int] = []
    while unused.any():
        anchor = int(rng.choice(np.flatnonzero(unused)))
        unused[anchor] = False
        batch = [anchor]
        if unused.any():
            row = batch_tanimoto(fps[anchor : anchor + 1], fps)[0]
            if not valid[anchor]:
                row[:] = -1.0
            row[~valid] = -1.0
            sims = np.where(unused, row, -np.inf)
            take = min(batch_size - 1, int(unused.sum()))
            picked = np.argpartition(-sims, take - 1)[:take] if take > 0 else []
            for j in sorted(picked, key=lambda j: -sims[j]):
                if unused[j]:
                    unused[j] = False
                    batch.append(int(j))
        order.extend(batch)
    return np.asarray(order)


def epoch_order(
    strategy: str, smiles: Sequence[str], batch_size: int, seed: int, epoch: int
) -> np.ndarray:
    if strategy == "shuffle":
        return shuffled_order(len(smiles), seed, epoch)
    if strategy == "weight_sorted":
        return weight_sorted_order(smiles, batch_size, seed, epoch)
    if strategy == "tanimoto":
        return tanimoto_anchor_order(smiles, batch_size, seed, epoch)
    raise ValueError(f"unknown order strategy {strategy!r}")
