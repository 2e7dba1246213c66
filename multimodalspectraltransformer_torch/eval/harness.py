"""The batch evaluation harness: candidates ranked by spectral error, scored by CLIP.

Counterpart of the JAX package's ``eval/harness.py``. Per batch of molecules:

encode -> teacher-forced probabilities -> greedy decode -> fan-out
multinomial candidates (temperature escalation, round-shrink,
validity/MW/dedup filters; optionally the beam hypotheses,
``DecodeConfig.beam_candidates``, and the greedy hypothesis,
``greedy_in_pool``) -> CLIP scores of every candidate against the molecule's
fingerprint (with ``clip_bundle``; report-only, ranking uses the spectral
errors unless the caller folds ``clip_loss`` in) -> simulated HSQC/COSY
spectra of the candidates (in a background thread that overlaps the decoding
rounds) -> assignment error, batched through kernel K2 (or per candidate on
the host, ``spectral_scorer="host"``) -> rank by the average of the HSQC and
COSY error ranks -> top-k accuracy. ``DecodeConfig.band_max_len`` cuts the
decode length to the batch's targets.

With ``mesh`` every rank calls ``evaluate_molecules`` with the same records on
its own device (SPMD): the featurized records are padded to a multiple of the
data extent by repeating the last one, each rank runs every stage on its
contiguous block, and the results are gathered in order, trimmed of the pad
and summarised on every rank, as one process would give them.
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
from ..parallel.collectives import dp_gather_rows
from ..parallel.mesh import RankShard, rank_shard
from ..rank import clip as clip_mod
from ..rank import matching
from ..sim import factory as sim_factory
from ..train.contrastive import clip_tokenize
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
    # sampling, clip when scored, simulate, score, assemble), each ending in a
    # device sync
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
    clip_block: int = 0,
    extra_candidates: Optional[Sequence[Sequence[str]]] = None,
    spectral_scorer: str = "device",
    device: DeviceLike = None,
    mesh: Optional[Any] = None,
) -> tuple[list[MoleculeResult], EvalSummary]:
    """Evaluate molecules end to end on ``device`` (cuda unless asked).

    ``clip_bundle``: ``(CLIPRanker, CLIPConfig)`` as ``rank.clip.load_bundle``
    returns it; every candidate then gets ``clip_loss`` and ``clip_dot``.
    ``clip_block``: the least width of a molecule's CLIP block (candidates
    padded by repeating the last one; wider pools are bucketed to
    ``clip_block`` plus a multiple of 8). ``extra_candidates[i]``: external
    candidate SMILES for ``records[i]``, merged into its sampled set before
    scoring and ranking. ``spectral_scorer``: "device" (every pair of a
    modality in one K2 call) or "host" (``matching.spectral_error`` per
    candidate, ``hung_dist_nn``). ``mesh``: every rank of it evaluates its
    block of the records on ``device``, its own, and gets every result;
    ``stage_seconds`` and ``mols_per_sec`` are the slowest rank's."""
    if spectral_scorer not in ("device", "host"):
        raise ValueError(f"spectral_scorer must be 'device' or 'host', got {spectral_scorer!r}")
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

    n_real = len(feats)
    shard = None
    if mesh is not None:
        # pad by repeating the last record so the count splits evenly; each
        # rank keeps its block (the decode length is banded on the whole batch)
        shard = rank_shard(mesh)
        pad = (-n_real) % shard.dp_size
        feats = feats + [feats[-1]] * pad
        kept_records = kept_records + [kept_records[-1]] * pad
        if kept_extras is not None:
            kept_extras = kept_extras + [()] * pad
    tb = dp.collate(feats)
    decode_len = banded_decode_len(tb.trg_tokens, dcfg.max_len) if dcfg.band_max_len else dcfg.max_len
    if shard is not None:
        rows = shard.rows(len(feats) // shard.dp_size)
        feats, kept_records = feats[rows], kept_records[rows]
        kept_extras = kept_extras[rows] if kept_extras is not None else None
        tb = dp.TrainBatch(MMTBatch(*(x[rows] for x in tb.inputs)), tb.trg_tokens[rows],
                           tb.trg_fp[rows])
    t_start = time.perf_counter()
    clock[0] = t_start
    enc = model.encode(MMTBatch(*tb.inputs).to(dev))
    mark("encode")
    trg = torch.from_numpy(tb.trg_tokens).to(dev)
    seq_probs = teacher_forced_analysis(model, trg, enc.memory, enc.memory_key_padding_mask)[
        "corr_sampling_prob"].cpu().numpy()
    mark("teacher_forced")

    params = model.state_dict()
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
            on_round_accepted=on_accept, device=dev, max_len=decode_len, shard=shard,
            n_global=n_real,
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

    clip_scores: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    if all_cands is not None and clip_bundle is not None:
        clip_scores = _clip_scores(clip_bundle, all_cands, enc.fingerprint, clip_block,
                                   dcfg.compute_dtype, dev, shard)
        mark("clip")

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

    # all (molecule, candidate) pairs of a modality in one kernel call, or
    # one host solve per pair
    device_errors: dict[tuple[int, str], list[float]] = {}
    if all_cands is not None and simulate_errors and spectral_scorer == "host":
        for i, rec in enumerate(kept_records):
            if rec.hsqc is None:
                continue
            for smi in all_cands[i].smiles:
                sr = sim_by_smi.get(smi)
                if sr is None:
                    continue
                errs = device_errors.setdefault((i, smi), [float("nan"), float("nan")])
                for mod_idx, mod in enumerate(("hsqc", "cosy")):
                    if getattr(rec, mod) and getattr(sr, mod):
                        errs[mod_idx] = matching.spectral_error(
                            np.asarray(getattr(rec, mod), float), np.asarray(getattr(sr, mod), float),
                            "hung_dist_nn")
    elif all_cands is not None and simulate_errors:
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
            if i in clip_scores:
                for c, loss, dot in zip(res.candidates, *clip_scores[i]):
                    c.clip_loss = float(loss)
                    c.clip_dot = float(dot)
            for c in res.candidates:
                errs = device_errors.get((i, c.smiles))
                if errs is not None:
                    c.hsqc_error, c.cosy_error = errs
            res.candidates.sort(key=lambda c: -c.tanimoto)
        res.wall_time_s = time.perf_counter() - t0
        results.append(res)
    if shard is None:
        summary = summarize(results)
    mark("assemble")
    total = time.perf_counter() - t_start
    if shard is not None:  # every rank's results in order, without the pad
        results = dp_gather_rows(results, shard)[:n_real]
        clocks = dp_gather_rows([(total, stages)], shard)
        total = max(t for t, _ in clocks)
        stages = {k: max(st.get(k, 0.0) for _, st in clocks) for k in stages}
        summary = summarize(results)
    summary.mols_per_sec = len(results) / total if total > 0 else 0.0
    summary.stage_seconds = stages
    return results, summary


def clip_block_width(n_max: int, clip_block: int) -> int:
    """The CLIP block's width for pools of at most ``n_max`` candidates: at
    least ``clip_block``; above it, ``clip_block`` plus a multiple of 8, so
    that pools of nearby sizes share one shape."""
    width = max(clip_block, n_max)
    if width > clip_block:
        width = clip_block + (width - clip_block + 7) // 8 * 8
    return width


def _clip_scores(clip_bundle: tuple, all_cands: list, fingerprints: torch.Tensor, clip_block: int,
                 compute_dtype: Optional[str], dev: torch.device,
                 shard: Optional[RankShard] = None) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """CLIP loss and dot similarity of every candidate, each molecule's block
    against its fingerprint, all molecules in one pass: {molecule index:
    (losses, dots)} over its real candidates. Short blocks repeat their last
    candidate; the padding enters the block's soft targets, as in the JAX
    harness. Under ``shard`` the block width is the global batch's."""
    clip_model, ccfg = clip_bundle
    with_cands = [i for i, cs in enumerate(all_cands) if cs.smiles]
    n_max = max(dp_gather_rows([max((len(cs.smiles) for cs in all_cands), default=0)], shard))
    if not with_cands:
        return {}
    width = clip_block_width(n_max, clip_block)
    blocks, n_reals = [], []
    for i in with_cands:
        smis = all_cands[i].smiles
        n_reals.append(len(smis))
        blocks += smis + [smis[-1]] * (width - len(smis))
    toks, mask = clip_tokenize(blocks, ccfg.text_max_len)
    shape = (len(with_cands), width, ccfg.text_max_len)
    score = clip_mod.score_candidates_batch(
        clip_model.to(dev), ccfg, torch.from_numpy(toks).reshape(shape).to(dev),
        torch.from_numpy(mask).reshape(shape).to(dev), fingerprints[with_cands],
        compute_dtype=compute_dtype)
    losses = score.losses.cpu().numpy()
    dots = score.dot_similarity.cpu().numpy()
    return {i: (losses[j, :n], dots[j, :n]) for j, (i, n) in enumerate(zip(with_cands, n_reals))}


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
