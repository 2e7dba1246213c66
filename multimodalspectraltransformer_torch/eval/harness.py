"""The batch evaluation harness: spectral-error ranking of sampled candidates.

Counterpart of the JAX package's ``eval/harness.py`` with CLIP scoring off
(``clip_bundle=None``, a supported configuration there: CLIP is report-only
and ranking uses the spectral errors). Per batch of molecules:

encode -> teacher-forced probabilities -> greedy decode -> fan-out
multinomial candidates (temperature escalation, round-shrink,
validity/MW/dedup filters; optionally the beam hypotheses,
``DecodeConfig.beam_candidates``, and the greedy hypothesis,
``greedy_in_pool``) -> simulated HSQC/COSY spectra of the candidates (in a
background thread that overlaps the decoding rounds) -> batched assignment
error (kernel K2) -> rank by the average of the HSQC and COSY error ranks ->
top-k accuracy. ``DecodeConfig.band_max_len`` cuts the decode length to the
batch's targets.
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..chem import api as chem
from ..data import pipeline as dp
from ..decode import samplers
from ..models.mmt import MMTBatch, MultimodalTransformer
from ..rank import matching
from ..sim import factory as sim_factory
from ..utils import vocab
from ..utils.config import DecodeConfig
from ..utils.device import DeviceLike, resolve_device
from . import generation


@dataclass
class CandidateResult:
    smiles: str
    seq_prob: float = 0.0
    tanimoto: float = 0.0
    exact: bool = False
    clip_loss: float = float("nan")
    clip_dot: float = float("nan")
    hsqc_error: float = float("nan")
    cosy_error: float = float("nan")


@dataclass
class MoleculeResult:
    target: str
    greedy: str = ""
    greedy_valid: bool = False
    greedy_exact: bool = False
    greedy_tanimoto: float = 0.0
    corr_sampling_prob: float = 0.0  # teacher-forced P(sequence)
    candidates: list[CandidateResult] = field(default_factory=list)
    sampling_rounds: int = 0
    wall_time_s: float = 0.0

    @property
    def best_tanimoto(self) -> float:
        return max((c.tanimoto for c in self.candidates), default=0.0)

    @property
    def mns_exact(self) -> bool:
        """'MNS exact recovery': the target structure appears in the sampled
        candidate pool (the headline metric of BASELINE.md). Equivalent to
        the reference's tanimoto-sorted top-rank == 1.0 criterion whenever
        fingerprints compute (an exact match has tanimoto exactly 1.0 and
        sorts first); set membership is the robust formulation."""
        return any(c.exact for c in self.candidates)


@dataclass
class EvalSummary:
    n: int = 0
    greedy_validity: float = 0.0
    greedy_exact: float = 0.0
    greedy_tanimoto: float = 0.0
    mns_exact: float = 0.0
    avg_best_tanimoto: float = 0.0
    corr_sampling_prob: float = 0.0
    top_k_accuracy: dict = field(default_factory=dict)
    mols_per_sec: float = 0.0
    # host seconds per stage of the last run (encode, teacher_forced, greedy,
    # sampling, simulate, score, assemble), each ending in a device sync
    stage_seconds: dict = field(default_factory=dict)




@torch.no_grad()
def teacher_forced_analysis(model: MultimodalTransformer, trg_tokens: torch.Tensor,
                            memory: torch.Tensor, kpm: torch.Tensor) -> dict:
    """Per-token P(correct) and P(argmax) under teacher forcing, whether the
    argmax is the target, and the product/mean aggregates."""
    logits = model.decode(trg_tokens[:, :-1], memory, kpm)
    probs = torch.softmax(logits, dim=-1)
    targets = trg_tokens[:, 1:].long()
    p_correct = probs.gather(-1, targets[..., None])[..., 0]
    p_max, amax = probs.max(dim=-1)
    argmax_is_target = amax == targets
    live = (targets != vocab.PAD_ID).to(probs.dtype)
    n_live = live.sum(dim=1).clamp_min(1.0)
    logp_live = torch.log(p_correct.clamp_min(1e-30)) * live
    return {
        "p_correct": p_correct,
        "p_max": p_max,
        "argmax_is_target": argmax_is_target,
        "corr_sampling_prob": torch.exp(logp_live.sum(dim=1)),
        "mean_token_prob": (p_correct * live).sum(dim=1) / n_live,
        "mean_max_prob": (p_max * live).sum(dim=1) / n_live,
        "token_accuracy": (argmax_is_target * live).sum(dim=1) / n_live,
    }


def evaluate_molecules(
    records: Sequence[dp.SampleRecord],
    model: MultimodalTransformer,
    dcfg: DecodeConfig = DecodeConfig(),
    seed: int = 0,
    clip_bundle: Optional[tuple] = None,
    simulate_errors: bool = True,
    sim_kwargs: Optional[dict] = None,
    run_mns: bool = True,
    extra_candidates: Optional[Sequence[Sequence[str]]] = None,
    device: DeviceLike = None,
) -> tuple[list[MoleculeResult], EvalSummary]:
    """Evaluate molecules end to end on ``device`` (cuda unless asked).

    ``extra_candidates[i]``: external candidate SMILES for ``records[i]``,
    merged into its sampled set before simulation and ranking."""
    if clip_bundle is not None:
        raise NotImplementedError("CLIP scoring is not ported yet: pass clip_bundle=None")
    dev = resolve_device(device)
    model = model.to(dev)
    mcfg = model.cfg
    sim_kwargs = dict(sim_kwargs or {}, device=dev)
    stages: dict[str, float] = {}
    clock = [time.perf_counter()]

    def mark(label: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages[label] = stages.get(label, 0.0) + now - clock[0]
        clock[0] = now

    feats, kept_records = [], []
    kept_extras = [] if extra_candidates is not None else None
    for idx, r in enumerate(records):
        f = dp.featurize(r, mcfg)
        if f is not None:
            feats.append(f)
            kept_records.append(r)
            if kept_extras is not None:
                kept_extras.append(extra_candidates[idx] if idx < len(extra_candidates) else ())
    if not feats:
        return [], EvalSummary()

    tb = dp.collate(feats)
    t_start = time.perf_counter()
    clock[0] = t_start
    enc = model.encode(MMTBatch(*tb.inputs).to(dev))
    mark("encode")
    trg = torch.from_numpy(tb.trg_tokens).to(dev)
    seq_probs = teacher_forced_analysis(model, trg, enc.memory, enc.memory_key_padding_mask)[
        "corr_sampling_prob"].cpu().numpy()
    mark("teacher_forced")

    params = model.state_dict()
    decode_len = banded_decode_len(tb.trg_tokens, dcfg.max_len) if dcfg.band_max_len else dcfg.max_len
    greedy_res = samplers.greedy_decode(
        params, mcfg, enc.memory, enc.memory_key_padding_mask, 1.0, decode_len,
        compute_dtype=dcfg.compute_dtype, device=dev,
    )
    greedy = vocab.batch_ids_to_smiles(greedy_res.tokens.cpu().numpy())
    greedy_cans = chem.batch_canonicalize(greedy)
    mark("greedy")

    # candidate-spectra simulation overlaps the sampling rounds: accepted
    # candidates go to one background worker per round
    all_cands = None
    sim_futures: list = []
    sim_seen: set = set()
    sim_pool = None
    on_accept = None
    if run_mns and simulate_errors:
        sim_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

        def on_accept(pairs):
            fresh = []
            for i, smis in pairs:
                if kept_records[i].hsqc is None:
                    continue
                for s in smis:
                    if s not in sim_seen:
                        sim_seen.add(s)
                        fresh.append(s)
            if fresh:
                sim_futures.append(sim_pool.submit(sim_factory.simulate_records, fresh, **sim_kwargs))

    if run_mns:
        all_cands = generation.generate_candidates_batch(
            params, mcfg, enc.memory, enc.memory_key_padding_mask, seed, dcfg,
            target_mws=[float(f["mw"]) for f in feats],
            on_round_accepted=on_accept, device=dev, max_len=decode_len,
        )
    mark("sampling")
    if all_cands is not None and dcfg.greedy_in_pool:
        # the reference's sampling_method="mix": the greedy hypothesis joins
        # the pool through the same canonical, dedup and MW gates
        for i, can in enumerate(greedy_cans):
            cs = all_cands[i]
            tmw = float(feats[i]["mw"]) if dcfg.mw_filter else None
            if can is None or can in cs.smiles or not generation.mw_matches(can, tmw, dcfg.mw_delta):
                continue
            cs.smiles.append(can)
            cs.seq_probs.append(0.0)  # ranked by spectral error, not sampling probability
    if kept_extras is not None:
        if all_cands is None:
            all_cands = [generation.CandidateSet() for _ in feats]
        for i, smis in enumerate(kept_extras):
            cs = all_cands[i]
            have = set(cs.smiles)
            for can in chem.batch_canonicalize(list(smis)):
                if can is None or can in have:
                    continue
                have.add(can)
                cs.smiles.append(can)
                cs.seq_probs.append(0.0)

    # one factory pass over the union of candidates not simulated yet
    sim_by_smi: dict[str, Any] = {}
    if all_cands is not None and simulate_errors:
        if sim_pool is not None:
            for fut in sim_futures:
                for sr in fut.result():
                    sim_by_smi[sr.smiles] = sr
            sim_pool.shutdown()
        union: list[str] = []
        seen_u: set = set(sim_by_smi)
        for i, rec in enumerate(kept_records):
            if rec.hsqc is None:
                continue
            for smi in all_cands[i].smiles:
                if smi not in seen_u:
                    seen_u.add(smi)
                    union.append(smi)
        if union:
            for sr in sim_factory.simulate_records(union, **sim_kwargs):
                sim_by_smi[sr.smiles] = sr
    mark("simulate")

    # all (molecule, candidate) pairs of a modality in one kernel call
    device_errors: dict[tuple[int, str], list[float]] = {}
    if all_cands is not None and simulate_errors:
        q_rows: dict[str, list] = {"hsqc": [], "cosy": []}
        c_rows: dict[str, list] = {"hsqc": [], "cosy": []}
        refs: dict[str, list] = {"hsqc": [], "cosy": []}
        for i, rec in enumerate(kept_records):
            if rec.hsqc is None:
                continue
            for smi in all_cands[i].smiles:
                sr = sim_by_smi.get(smi)
                if sr is None:
                    continue
                for mod in ("hsqc", "cosy"):
                    if getattr(rec, mod) and getattr(sr, mod):
                        q_rows[mod].append(np.asarray(getattr(rec, mod), float))
                        c_rows[mod].append(np.asarray(getattr(sr, mod), float))
                        refs[mod].append((i, smi))
        for mod_idx, mod in enumerate(("hsqc", "cosy")):
            errs = matching.batched_pairwise_assignment_error(q_rows[mod], c_rows[mod], device=dev)
            for key, e in zip(refs[mod], errs):
                device_errors.setdefault(key, [float("nan"), float("nan")])[mod_idx] = float(e)
    mark("score")

    target_cans = chem.batch_canonicalize([f["smiles"] for f in feats])
    cand_smis: list[str] = []
    if all_cands is not None:
        for cs in all_cands:
            cand_smis.extend(cs.smiles)
    fps, fps_ok = chem.batch_morgan_fp(
        [c or "" for c in target_cans] + [c or "" for c in greedy_cans] + cand_smis
    )
    nf = len(feats)
    t_fp, g_fp, c_fp = fps[:nf], fps[nf : 2 * nf], fps[2 * nf :]
    t_ok, g_ok, c_ok = fps_ok[:nf], fps_ok[nf : 2 * nf], fps_ok[2 * nf :]

    def _fp_tanimoto(fa, ok_a, fb, ok_b) -> float:
        if not (ok_a and ok_b):
            return 0.0
        union = int(np.sum(fa | fb))
        return float(np.sum(fa & fb)) / union if union else 0.0

    cand_off = 0
    results: list[MoleculeResult] = []
    for i, (rec, f) in enumerate(zip(kept_records, feats)):
        t0 = time.perf_counter()
        res = MoleculeResult(target=f["smiles"], corr_sampling_prob=float(seq_probs[i]))
        res.greedy = greedy[i]
        res.greedy_valid = greedy_cans[i] is not None
        res.greedy_exact = greedy_cans[i] is not None and greedy_cans[i] == target_cans[i]
        res.greedy_tanimoto = _fp_tanimoto(g_fp[i], g_ok[i], t_fp[i], t_ok[i])
        if all_cands is not None:
            cand = all_cands[i]
            res.sampling_rounds = cand.rounds_used
            for smi, p in zip(cand.smiles, cand.seq_probs):
                cr = CandidateResult(smiles=smi, seq_prob=p)
                cr.tanimoto = _fp_tanimoto(c_fp[cand_off], c_ok[cand_off], t_fp[i], t_ok[i])
                cr.exact = smi == target_cans[i]
                cand_off += 1
                res.candidates.append(cr)
            for c in res.candidates:
                errs = device_errors.get((i, c.smiles))
                if errs is not None:
                    c.hsqc_error, c.cosy_error = errs
            res.candidates.sort(key=lambda c: -c.tanimoto)
        res.wall_time_s = time.perf_counter() - t0
        results.append(res)
    summary = summarize(results)
    mark("assemble")
    total = time.perf_counter() - t_start
    summary.mols_per_sec = len(results) / total if total > 0 else 0.0
    summary.stage_seconds = stages
    return results, summary


def banded_decode_len(trg_tokens: np.ndarray, max_len: int) -> int:
    """Decode-length banding: the smallest of {40, 56} that covers the
    longest target (rows <SOS> ... <EOS> <PAD>*; generated sequences carry no
    <SOS>) plus a 12-token margin and is below ``max_len``; else ``max_len``."""
    need = int((np.asarray(trg_tokens) != vocab.PAD_ID).sum(axis=1).max()) - 1 + 12
    return next((c for c in (40, 56) if need <= c < max_len), max_len)


def rank_candidates_by_error(
    res: MoleculeResult,
    mf_filter: bool = True,
    keys: Sequence[str] = ("hsqc_error", "cosy_error"),
) -> list[CandidateResult]:
    """Rank by the average of the per-key ranks (default: HSQC-error rank and
    COSY-error rank) after dedup and molecular-formula filtering
    (reference `experiment_function_v15_4.py:725-837`). Passing
    ``keys=("hsqc_error", "cosy_error", "clip_loss")`` folds a trained CLIP
    ranker's per-candidate loss into the average the way the reference's
    CLIP-scored results files feed its ranking analysis
    (`run_batch_gen_val_MMT_v15_4.py:428-482`)."""
    target_mf = chem.mol_formula(res.target)
    cands = []
    seen = set()
    for c in res.candidates:
        if c.smiles in seen:
            continue
        seen.add(c.smiles)
        if mf_filter and target_mf is not None:
            if chem.mol_formula(c.smiles) != target_mf:
                continue
        cands.append(c)
    if not cands:
        return []

    def ranks(key):
        vals = [getattr(c, key) for c in cands]
        vals = [v if np.isfinite(v) else np.inf for v in vals]
        order = np.argsort(vals, kind="stable")
        r = np.empty(len(cands))
        r[order] = np.arange(len(cands))
        return r

    avg_rank = sum(ranks(k) for k in keys) / len(keys)
    order = np.argsort(avg_rank, kind="stable")
    return [cands[int(j)] for j in order]


def top_k_hits(
    results: Sequence[MoleculeResult],
    ks=(1, 3, 5, 10, 20),
    mf_filter: bool = True,
    keys: Sequence[str] = ("hsqc_error", "cosy_error"),
) -> tuple[dict, int]:
    """Raw (hits-per-k, denominator) counts behind :func:`top_k_accuracy`.

    Exposed separately so multi-chunk drivers can pool accuracies over the
    true molecule counts instead of averaging per-chunk fractions."""
    hits = {k: 0 for k in ks}
    n = 0
    for res in results:
        ranked = rank_candidates_by_error(res, mf_filter, keys=keys)
        if not ranked:
            # molecules whose whole pool was MF-filtered out (or that had
            # no candidates) are excluded from the denominator — the
            # reference drops empty keys before dividing
            # (filter_rankings_by_molecular_formula,
            # experiment_function_v15_4.py:857-858)
            continue
        n += 1
        for k in ks:
            if any(c.exact for c in ranked[:k]):
                hits[k] += 1
    return hits, n


def top_k_accuracy(results: Sequence[MoleculeResult], ks=(1, 3, 5, 10, 20), mf_filter: bool = True) -> dict:
    """Fraction of molecules whose true structure appears in the top-k of
    the error ranking (reference calculate_top_k_accuracy,
    `experiment_function_v15_4.py:885-901`)."""
    hits, n = top_k_hits(results, ks, mf_filter)
    return {k: (hits[k] / n if n else 0.0) for k in ks}


def summarize(results: Sequence[MoleculeResult]) -> EvalSummary:
    n = len(results)
    if n == 0:
        return EvalSummary()
    s = EvalSummary(n=n)
    s.greedy_validity = float(np.mean([r.greedy_valid for r in results]))
    s.greedy_exact = float(np.mean([r.greedy_exact for r in results]))
    s.greedy_tanimoto = float(np.mean([r.greedy_tanimoto for r in results]))
    s.mns_exact = float(np.mean([r.mns_exact for r in results]))
    s.avg_best_tanimoto = float(np.mean([r.best_tanimoto for r in results]))
    s.corr_sampling_prob = float(np.mean([r.corr_sampling_prob for r in results]))
    s.top_k_accuracy = top_k_accuracy(results)
    return s
