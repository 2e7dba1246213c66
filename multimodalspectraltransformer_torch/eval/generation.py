"""Candidate generation: fan-out sampling with temperature escalation.

Counterpart of the JAX package's ``eval/generation.py``. Per round, every
still-unsatisfied molecule samples ``fanout`` sequences (one
``multinomial_decode`` over all of them, lanes sharing their molecule's cross
K/V); host chemistry canonicalizes, dedups and MW-filters them until each
molecule holds ``multinom_runs`` unique valid SMILES; the temperature rises
by ``temp_increment`` per round up to ``max_temp_rounds``. After round 0 the
unsatisfied molecules are regathered into one of four widths
{ceil(B/4), ceil(B/2), ceil(2B/3), B} (``round_shrink``), and the
temperature is a per-lane vector [W*F, 1].

Rounds run one after another: the eager decode loop blocks the host at its
early-exit checks, so dispatching round k+1 before filtering round k (the
JAX ``lookahead``) would buy no overlap here and is not done. With
``beam_candidates > 0`` one batched beam search (kernel K3) runs after the
sampling rounds, and its hypotheses join each pool through the same
canonicalize/dedup/MW gates, as in the JAX package (which dispatches the
beam decode first and fetches it last; the beam decode is deterministic, so
only the merge order matters).

Under a mesh (``shard``) a rank samples for its block of the molecules, and
its candidates equal one process's: round-shrink is off, as in the JAX
package when the memory is sharded; each round the ranks share which
molecules are still unsatisfied, so every lane takes the Gumbel rows that one
process's packed round would give it (``multinomial_decode``'s
``lane_rows``). A rank that has no unsatisfied molecule left skips the
decode but still takes part in the exchange.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..chem import api as chem
from ..decode import samplers
from ..parallel.collectives import dp_gather_rows
from ..parallel.mesh import RankShard
from ..utils import vocab
from ..utils.config import DecodeConfig, ModelConfig
from ..utils.device import DeviceLike, resolve_device


@torch.no_grad()
def _fetch_pack(toks: torch.Tensor, tprobs: torch.Tensor):
    """Tokens as uint8 and the per-lane sequence probability, reduced on the
    device before the device->host copy."""
    live = toks != vocab.PAD_ID
    logp = torch.where(live, torch.log(tprobs.clamp_min(1e-38)), 0.0)
    seqp = torch.where(live.any(dim=1), torch.exp(logp.sum(dim=1)), 0.0)
    return toks.to(torch.uint8).cpu().numpy(), seqp.cpu().numpy()


@dataclass
class CandidateSet:
    """Unique, valid, canonicalized candidates for one molecule."""

    smiles: list[str] = field(default_factory=list)
    seq_probs: list[float] = field(default_factory=list)  # product of token probs
    rounds_used: int = 0
    n_sampled: int = 0


def _filter_block(
    tokens: np.ndarray,  # [F, T]
    probs: np.ndarray,  # [F, T] per-token probs, or [F] device-reduced seq probs
    target_mw: Optional[float],
    mw_delta: float,
    seen: set,
    out: CandidateSet,
    want: int,
    canons: Optional[list] = None,  # precomputed canonical SMILES per row
) -> None:
    """Host-side validity/canonicalize/dedup/MW filter of one device block
    (reference `:1035-1083` filter_probs_and_valid_smiles_and_canonicolize,
    filter_for_MW_2, deduplicate_smiles). Canonicalization runs through the
    batched native C++ kernel when `canons` is not supplied."""
    if canons is None:
        canons = chem.batch_canonicalize([vocab.ids_to_smiles(r) for r in tokens])
    for row, prow, can in zip(tokens, probs, canons):
        if len(out.smiles) >= want:
            return
        out.n_sampled += 1
        if can is None or can in seen or not mw_matches(can, target_mw, mw_delta):
            continue
        seen.add(can)
        if np.ndim(prow) == 0:  # device-reduced sequence probability
            p = float(prow)
        else:
            live = row != vocab.PAD_ID
            p = float(np.prod(prow[live])) if live.any() else 0.0
        out.smiles.append(can)
        out.seq_probs.append(p)


def mw_matches(can: str, target_mw: Optional[float], mw_delta: float) -> bool:
    """The reference's MW gate (`:1083`): rounded weights within +-delta;
    everything passes without a target."""
    if target_mw is None:
        return True
    mw = chem.mol_wt(can)
    return mw is not None and abs(round(mw) - round(target_mw)) <= mw_delta


def round_widths(B: int) -> tuple[int, ...]:
    """The four static round-shrink widths {ceil(B/4), ceil(B/2), ceil(2B/3), B}."""
    return (max(1, (B + 3) // 4), max(1, (B + 1) // 2), max(1, (2 * B + 2) // 3), B)


def round_seed(seed: int, round_idx: int) -> int:
    return (int(seed) * 1_000_003 + round_idx) % (2**63)


def generate_candidates(
    params,
    mcfg: ModelConfig,
    memory: torch.Tensor,  # [1, S, D]: one molecule's encoder memory
    memory_kpm: torch.Tensor,
    seed: int = 0,
    dcfg: DecodeConfig = DecodeConfig(),
    target_mw: Optional[float] = None,
    device: DeviceLike = None,
) -> CandidateSet:
    """Temperature-escalation fan-out sampling for one molecule:
    ``generate_candidates_batch`` with B = 1."""
    return generate_candidates_batch(
        params, mcfg, memory, memory_kpm, seed, dcfg,
        target_mws=None if target_mw is None else [target_mw], device=device,
    )[0]


def generate_candidates_batch(
    params,
    mcfg: ModelConfig,
    memory: torch.Tensor,  # [B, S, D]: many molecules at once
    memory_kpm: torch.Tensor,
    seed: int = 0,
    dcfg: DecodeConfig = DecodeConfig(),
    target_mws: Optional[list] = None,
    compute_dtype: Optional[str] = None,
    on_round_accepted=None,
    device: DeviceLike = None,
    max_len: Optional[int] = None,  # overrides dcfg.max_len (length banding)
    shard: Optional[RankShard] = None,
    n_global: Optional[int] = None,
) -> list[CandidateSet]:
    """Fan-out sampling for a batch of molecules, one decode per round, then
    the beam hypotheses when ``dcfg.beam_candidates > 0``. Round ``k``
    samples from a generator seeded by ``round_seed(seed, k)``. Under
    ``shard`` the batch is this rank's block of the global batch, whose first
    ``n_global`` molecules are real (the rest pad it to a multiple of the
    ranks: they get no candidates)."""
    dev = resolve_device(device)
    memory, memory_kpm = memory.to(dev), memory_kpm.to(dev)
    B = memory.shape[0]
    F = dcfg.fanout
    outs = [CandidateSet() for _ in range(B)]
    seens: list[set] = [set() for _ in range(B)]
    want = dcfg.multinom_runs
    compute_dtype = compute_dtype or dcfg.compute_dtype
    decode_len = max_len if max_len is not None else dcfg.max_len
    mws = target_mws if (target_mws is not None and dcfg.mw_filter) else [None] * B
    sharded = shard is not None and shard.dp_size > 1
    shrink = dcfg.round_shrink and B > 1 and not sharded
    widths = round_widths(B) if shrink else (B,)
    gen = torch.Generator(device=dev)
    offset = shard.dp_index * B if sharded else 0
    n_global = n_global if n_global is not None else B * (shard.dp_size if sharded else 1)

    def noise_rows(everyone: list, lanes: list) -> dict:
        """Each lane's rows of the global round's Gumbel draw: its molecule's
        place among every rank's unsatisfied molecules (``everyone``, global
        indices), as one process packs them."""
        pos = {g: j for j, g in enumerate(everyone)}
        rows = torch.tensor([pos[offset + b] * F + f for b in lanes for f in range(F)],
                            dtype=torch.long, device=dev)
        return dict(global_lanes=n_global * F, lane_rows=rows)

    def decode(round_idx: int, idxs: list, everyone: Optional[list] = None):
        W = next(w for w in widths if len(idxs) <= w)
        lanes = idxs + [idxs[-1]] * (W - len(idxs))
        shared = noise_rows(everyone, lanes) if everyone is not None else {}
        if lanes == list(range(B)):
            mem, kpm = memory, memory_kpm
        else:
            ia = torch.tensor(lanes, dtype=torch.long, device=dev)
            mem, kpm = memory[ia], memory_kpm[ia]
        t = dcfg.temperature + round_idx * dcfg.temp_increment
        lane_temp = torch.full((W * F, 1), t, dtype=torch.float32, device=dev)
        gen.manual_seed(round_seed(seed, round_idx))
        res = samplers.multinomial_decode(
            params, mcfg, mem, kpm, gen, lane_temp, decode_len, fanout=F,
            compute_dtype=compute_dtype, device=dev, **shared,
        )
        return res, lanes

    # no round when no sample is wanted; none for padding molecules
    active = [b for b in range(B) if offset + b < n_global] if want > 0 else []
    for round_idx in range(dcfg.max_temp_rounds):
        everyone = None
        if sharded:  # every rank joins each round's exchange until none is unsatisfied
            everyone = dp_gather_rows([offset + b for b in active], shard)
            if not everyone:
                break
            if not active:
                continue
        elif not active:
            break
        res, lanes = decode(round_idx, active, everyone)
        W = len(lanes)
        toks_u8, seqp = _fetch_pack(res.tokens, res.token_probs)
        tokens = toks_u8.reshape(W, F, -1)
        probs = seqp.reshape(W, F)
        # each unsatisfied molecule's first lane-row (pad rows repeat the last)
        consume = [(j, b) for j, b in enumerate(lanes) if j == lanes.index(b)]
        flat_smiles = [vocab.ids_to_smiles(r) for j, _ in consume for r in tokens[j]]
        canons = chem.batch_canonicalize(flat_smiles)
        pre_lens = {b: len(outs[b].smiles) for _, b in consume}
        for ci, (j, b) in enumerate(consume):
            _filter_block(tokens[j], probs[j], mws[b], dcfg.mw_delta, seens[b], outs[b], want,
                          canons=canons[ci * F : (ci + 1) * F])
            outs[b].rounds_used = round_idx + 1
        if on_round_accepted is not None:
            newly = [(b, outs[b].smiles[pre_lens[b]:]) for _, b in consume
                     if len(outs[b].smiles) > pre_lens[b]]
            if newly:
                on_round_accepted(newly)
        active = [b for b in range(B) if len(outs[b].smiles) < want]

    if dcfg.beam_candidates > 0:
        _merge_beam(params, mcfg, memory, memory_kpm, dcfg, decode_len, compute_dtype, dev,
                    mws, seens, outs, on_round_accepted)
    return outs


def _merge_beam(params, mcfg, memory, memory_kpm, dcfg: DecodeConfig, decode_len: int,
                compute_dtype, dev, mws: list, seens: list, outs: list, on_round_accepted) -> None:
    """Merge the top ``dcfg.beam_candidates`` beam hypotheses of every
    molecule into its pool, after the sampling rounds: each counts in
    ``n_sampled``; the pool's ``seen`` set dedups them; the MW gate applies;
    the sequence probability is exp(score); ``multinom_runs`` does not cap
    them. One ``on_round_accepted`` call carries the additions."""
    B, K = memory.shape[0], dcfg.beam_candidates
    res = samplers.beam_search(params, mcfg, memory, memory_kpm, beam_size=K, max_len=decode_len,
                               compute_dtype=compute_dtype, device=dev)
    btoks = res.tokens.cpu().numpy()  # [B, K, T]
    bscores = res.scores.cpu().numpy()  # [B, K] summed log-probs
    canons = chem.batch_canonicalize([vocab.ids_to_smiles(r) for r in btoks.reshape(B * K, -1)])
    pre = [len(o.smiles) for o in outs]
    for b in range(B):
        out, seen, tmw = outs[b], seens[b], mws[b]
        for k in range(K):
            can = canons[b * K + k]
            out.n_sampled += 1
            if can is None or can in seen or not mw_matches(can, tmw, dcfg.mw_delta):
                continue
            seen.add(can)
            out.smiles.append(can)
            out.seq_probs.append(float(np.exp(bscores[b, k])))
    if on_round_accepted is not None:
        newly = [(b, outs[b].smiles[pre[b]:]) for b in range(B) if len(outs[b].smiles) > pre[b]]
        if newly:
            on_round_accepted(newly)


def greedy_smiles(
    params, mcfg: ModelConfig, memory: torch.Tensor, memory_kpm: torch.Tensor, max_len: int = 128,
    compute_dtype: Optional[str] = None, device: DeviceLike = None,
) -> list[str]:
    """Greedy decode -> raw SMILES strings."""
    res = samplers.greedy_decode(params, mcfg, memory, memory_kpm, 1.0, max_len,
                                 compute_dtype=compute_dtype, device=device)
    return vocab.batch_ids_to_smiles(res.tokens.cpu().numpy())
