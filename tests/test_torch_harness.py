"""The port's evaluation harness and candidate generation against the JAX
package.

``evaluate_molecules`` gets the same records and the same injected
candidates on both sides (sampling off, so both candidate sets are the
injected ones). The candidate sets must be equal. The spectral errors of
both packages are held to scipy's optimum (the host engine's
``hung_dist_zero``), not to each other bit for bit, since off the TPU the JAX
harness solves with another auction: the port's within N * eps (N <= 64,
eps <= 2e-5, plus float slack: 1.5e-3 per peak); the JAX scorer's within
N * 1e-4 where it converges. Where the JAX scorer misses the optimum (a fault
of the reference, logged in ROADMAP.md), the port must still hit it. The
ranking must equal the JAX ranking of the same candidates under the optimal
errors."""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.chem import tokenizer as ttok
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.eval import generation as tgen
from multimodalspectraltransformer_torch.eval import harness as th
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.ops import auction, decode_attention
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.data import molrandom
from multimodalspectraltransformer_tpu.eval import generation as jgen
from multimodalspectraltransformer_tpu.eval import harness as jh
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.rank import matching as jm
from multimodalspectraltransformer_tpu.sim import factory as jfactory
from multimodalspectraltransformer_tpu.utils.config import DecodeConfig, ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
ERR_TOL = 64 * 1e-4  # N * eps of the JAX off-TPU auction (eps 1e-4), per peak at most
PORT_TOL = 1.5e-3  # N * eps of the port's auction (N <= 64, eps <= 2e-5) + float slack

_CACHE: dict = {}


def _phase3():
    if "m" not in _CACHE:
        from multimodalspectraltransformer_tpu.train import checkpoint

        params = checkpoint.import_params_msgpack(
            jmmt.init_params(ModelConfig(), jax.random.PRNGKey(0)), PHASE3)
        _CACHE["m"] = (params, tmmt.load_model(PHASE3, tconfig.ModelConfig(), device="cpu"))
    return _CACHE["m"]


def _records(n: int):
    smis = molrandom.random_corpus(2 * n, seed=123)[:n]
    return jfactory.simulate_records(smis), tfactory.simulate_records(smis, device="cpu")


def test_evaluate_molecules_matches_jax_with_injected_candidates():
    params, model = _phase3()
    jrecs, trecs = _records(3)
    extras = [
        [r.smiles, "CCO", "c1ccccc1O", "CC(=O)OC", "not a smiles"] + molrandom.random_corpus(4, seed=i)
        for i, r in enumerate(jrecs)
    ]
    dcfg = DecodeConfig(max_len=64)
    jres, jsum = jh.evaluate_molecules(jrecs, params, ModelConfig(), dcfg, run_mns=False,
                                       extra_candidates=extras)
    tres, tsum = th.evaluate_molecules(trecs, model, dcfg, run_mns=False,
                                       extra_candidates=extras, device="cpu")
    assert len(jres) == len(tres) == 3
    sims = {r.smiles: r for r in tfactory.simulate_records(
        [c.smiles for r in tres for c in r.candidates], device="cpu")}
    n_checked = n_reference_misses = 0
    for rec, a, b in zip(trecs, jres, tres):
        assert a.target == b.target and a.greedy == b.greedy
        assert a.greedy_exact == b.greedy_exact and a.greedy_tanimoto == b.greedy_tanimoto
        assert abs(a.corr_sampling_prob - b.corr_sampling_prob) <= 1e-4 * max(1.0, a.corr_sampling_prob)
        assert [c.smiles for c in a.candidates] == [c.smiles for c in b.candidates]
        for ca, cb in zip(a.candidates, b.candidates):
            assert cb.tanimoto == ca.tanimoto and cb.exact == ca.exact
            sr = sims.get(cb.smiles)
            for key, attr in (("hsqc_error", "hsqc"), ("cosy_error", "cosy")):
                x, y = getattr(ca, key), getattr(cb, key)
                assert np.isnan(x) == np.isnan(y), (cb.smiles, key)
                if np.isnan(y):
                    continue
                opt = jm.spectral_error(np.asarray(getattr(rec, attr)), np.asarray(getattr(sr, attr)),
                                        "hung_dist_zero")
                assert abs(y - opt) <= PORT_TOL, (cb.smiles, key, y, opt)
                n_checked += 1
                if abs(x - opt) > ERR_TOL:
                    n_reference_misses += 1
                else:
                    assert abs(x - y) <= ERR_TOL, (cb.smiles, key, x, y)
                # rank the JAX result under the optimal errors
                setattr(ca, key, opt)
        assert ([c.smiles for c in jh.rank_candidates_by_error(a)]
                == [c.smiles for c in th.rank_candidates_by_error(b)])
    assert n_checked >= 30 and n_reference_misses <= n_checked // 10
    assert tsum.greedy_validity == jsum.greedy_validity and tsum.mns_exact == jsum.mns_exact
    assert tsum.top_k_accuracy == th.top_k_accuracy(tres)


def test_evaluate_molecules_runs_the_whole_path_on_cpu():
    """Sampling on (small fan-out): every stage runs, every simulated
    candidate gets a spectral error, and no kernel is launched on the CPU."""
    _params, model = _phase3()
    _jrecs, trecs = _records(2)
    decode_attention.reset_launches()
    auction.reset_launches()
    dcfg = tconfig.DecodeConfig(max_len=40, fanout=8, multinom_runs=3, max_temp_rounds=2)
    res, summary = th.evaluate_molecules(trecs, model, dcfg, seed=3, device="cpu")
    assert summary.n == 2 and len(res) == 2
    assert set(summary.stage_seconds) == {"encode", "teacher_forced", "greedy", "sampling",
                                          "simulate", "score", "assemble"}
    assert all(1 <= r.sampling_rounds <= 2 for r in res)
    for r in res:
        assert len(r.candidates) <= 3
        for c in r.candidates:
            assert np.isfinite(c.hsqc_error)
    assert decode_attention.launches == 0 and auction.launches == 0
    again, _ = th.evaluate_molecules(trecs, model, dcfg, seed=3, device="cpu")
    assert [[c.smiles for c in r.candidates] for r in again] == [[c.smiles for c in r.candidates]
                                                                 for r in res]


def test_filter_block_matches_jax():
    smis = ["CCO", "OCC", "C(O)C", "c1ccccc1", "C1CC", "CCCl", "CCO", "CC(=O)O", "CCN"] * 2
    toks = np.stack([ttok.encode_smiles_framed(s, 32)[0][1:] for s in smis]).astype(np.int64)
    probs = np.linspace(0.1, 0.9, len(smis)).astype(np.float32)
    for target_mw, want in ((46.07, 10), (None, 4), (None, 10)):
        outs = []
        for mod in (jgen, tgen):
            cs = mod.CandidateSet()
            mod._filter_block(toks, probs, target_mw, 0.5, set(), cs, want)
            outs.append(dataclasses.astuple(cs))
        assert outs[0] == outs[1]


def test_round_shrink_widths():
    assert tgen.round_widths(48) == (12, 24, 32, 48)
    assert tgen.round_widths(8) == (2, 4, 6, 8)
    assert tgen.round_widths(1) == (1, 1, 1, 1)


def test_ranking_and_topk_match_jax():
    rng = np.random.default_rng(0)
    target = "CCOC(=O)C"
    cands = ["CCOC(=O)C", "CCCC(=O)O", "COC(=O)CC", "CC(=O)OCC", "CCOCC=O", "CCCCCC"]
    jr = jh.MoleculeResult(target=target)
    tr = th.MoleculeResult(target=target)
    for smi in cands:
        h, c = rng.random(2)
        jr.candidates.append(jh.CandidateResult(smi, hsqc_error=h, cosy_error=c, exact=smi == target))
        tr.candidates.append(th.CandidateResult(smi, hsqc_error=h, cosy_error=c, exact=smi == target))
    tr.candidates[-2].cosy_error = jr.candidates[-2].cosy_error = float("nan")
    for mf in (True, False):
        assert ([c.smiles for c in jh.rank_candidates_by_error(jr, mf)]
                == [c.smiles for c in th.rank_candidates_by_error(tr, mf)])
    assert jh.top_k_accuracy([jr]) == th.top_k_accuracy([tr])
    assert dataclasses.asdict(jh.summarize([jr])) == {
        k: v for k, v in dataclasses.asdict(th.summarize([tr])).items() if k != "stage_seconds"}


def test_clip_scoring_is_refused_not_ignored():
    """CLIP scoring (not ported yet) raises; the beam, greedy-in-pool and
    length-banding options are ported and accepted."""
    _params, model = _phase3()
    with pytest.raises(NotImplementedError, match="CLIP"):
        th.evaluate_molecules([], model, clip_bundle=((), ()), device="cpu")
    dcfg = tconfig.DecodeConfig(beam_candidates=2, greedy_in_pool=True, band_max_len=True)
    assert th.evaluate_molecules([], model, dcfg, device="cpu") == ([], th.EvalSummary())


def test_featurize_records_roundtrip():
    """Records simulated by the port featurize into the model's layout."""
    _jrecs, trecs = _records(2)
    feats = [tdp.featurize(r, tconfig.ModelConfig()) for r in trecs]
    batch = tdp.collate(feats)
    assert batch.inputs.src_hsqc.shape == (2, 64, 2) and batch.trg_tokens.shape == (2, 64)
