"""The candidate pool's beam and greedy options of the port against the JAX
package: ``generate_candidates_batch`` with ``beam_candidates > 0`` and
``evaluate_molecules`` with ``greedy_in_pool`` and ``band_max_len``.

Sampling is switched off (``multinom_runs=0``: the JAX loop then consumes no
sampled lane), so both pools hold only the deterministic beam and greedy
hypotheses, decoded at float32 from the same encoder memory and the committed
phase3 weights. The candidate sets and ``n_sampled`` must be equal, the
sequence probabilities (exp of the beam score) within 1e-5."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.eval import generation as tgen
from multimodalspectraltransformer_torch.eval import harness as th
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_torch.utils import vocab as tvocab
from multimodalspectraltransformer_tpu.data import molrandom
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.eval import generation as jgen
from multimodalspectraltransformer_tpu.eval import harness as jh
from multimodalspectraltransformer_tpu.models import mmt as jmmt
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
N_MOLS = 3
# no sampled candidate wanted: the pools hold only the deterministic hypotheses
POOL = dict(max_len=40, fanout=2, multinom_runs=0, beam_candidates=3)

_CACHE: dict = {}


def _setup():
    """(JAX params, port model, JAX records, port records, memory, kpm, target MWs)."""
    if "s" not in _CACHE:
        from multimodalspectraltransformer_tpu.train import checkpoint

        cfg = ModelConfig()
        params = checkpoint.import_params_msgpack(jmmt.init_params(cfg, jax.random.PRNGKey(0)), PHASE3)
        model = tmmt.load_model(PHASE3, tconfig.ModelConfig(), device="cpu")
        smis = molrandom.random_corpus(2 * N_MOLS, seed=123)[:N_MOLS]
        jrecs = jfactory.simulate_records(smis)
        trecs = tfactory.simulate_records(smis, device="cpu")
        feats = [jdp.featurize(r, cfg) for r in jrecs]
        tb = jdp.collate(feats)
        enc = jax.jit(lambda p, b: jmmt.MultimodalTransformer(cfg).apply({"params": p}, b, None, True))(
            params, jax.tree.map(jnp.asarray, tb.inputs))
        mws = [float(f["mw"]) for f in feats]
        _CACHE["s"] = (params, model, jrecs, trecs, np.asarray(enc.memory),
                       np.asarray(enc.memory_key_padding_mask), mws)
    return _CACHE["s"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _assert_same_pool(a, b):
    assert b.smiles == a.smiles
    assert b.n_sampled == a.n_sampled and b.rounds_used == a.rounds_used
    np.testing.assert_allclose(b.seq_probs, a.seq_probs, atol=1e-5)


def test_beam_pool_matches_jax():
    """Beam hypotheses merged after the (empty) sampling rounds: the same
    pools, every hypothesis counted in n_sampled, and one on_round_accepted
    call carrying the same additions."""
    params, model, _jr, _tr, memory, kpm, mws = _setup()
    jcalls, tcalls = [], []
    jouts = jgen.generate_candidates_batch(
        params, ModelConfig(), jnp.asarray(memory), jnp.asarray(kpm), jax.random.PRNGKey(0),
        DecodeConfig(**POOL), target_mws=mws, on_round_accepted=jcalls.append)
    touts = tgen.generate_candidates_batch(
        model.state_dict(), model.cfg, _t(memory), _t(kpm), 0, tconfig.DecodeConfig(**POOL),
        target_mws=mws, on_round_accepted=tcalls.append, device="cpu")
    assert len(touts) == len(jouts) == N_MOLS
    for a, b in zip(jouts, touts):
        _assert_same_pool(a, b)
        assert b.n_sampled == POOL["beam_candidates"]
    assert sum(len(o.smiles) for o in touts) > 0
    assert tcalls == jcalls and len(tcalls) == 1


def test_generate_candidates_one_molecule_matches_jax():
    """generate_candidates (B = 1) without the MW gate."""
    params, model, _jr, _tr, memory, kpm, _mws = _setup()
    kw = dict(POOL, mw_filter=False)
    a = jgen.generate_candidates(params, ModelConfig(), jnp.asarray(memory[:1]), jnp.asarray(kpm[:1]),
                                 jax.random.PRNGKey(0), DecodeConfig(**kw))
    b = tgen.generate_candidates(model.state_dict(), model.cfg, _t(memory[:1]), _t(kpm[:1]), 0,
                                 tconfig.DecodeConfig(**kw), device="cpu")
    _assert_same_pool(a, b)


@pytest.mark.parametrize("option", ["greedy_in_pool", "band_max_len"])
def test_evaluate_molecules_pool_options_match_jax(option):
    """evaluate_molecules with the greedy hypothesis in the pool, or with the
    decode length banded to the targets (max_len 64 -> 40 or 56 here): the
    same greedy strings and the same pools (smiles and sequence probabilities)."""
    params, model, jrecs, trecs, _m, _k, _mws = _setup()
    kw = dict(POOL, max_len=64, beam_candidates=2, **{option: True})
    jres, _ = jh.evaluate_molecules(jrecs, params, ModelConfig(), DecodeConfig(**kw),
                                    simulate_errors=False)
    tres, _ = th.evaluate_molecules(trecs, model, tconfig.DecodeConfig(**kw), simulate_errors=False,
                                    device="cpu")
    assert len(jres) == len(tres) == N_MOLS
    n_greedy = 0
    for a, b in zip(jres, tres):
        assert b.greedy == a.greedy and b.sampling_rounds == a.sampling_rounds
        assert [c.smiles for c in b.candidates] == [c.smiles for c in a.candidates]
        np.testing.assert_allclose([c.seq_prob for c in b.candidates],
                                   [c.seq_prob for c in a.candidates], atol=1e-5)
        n_greedy += sum(c.seq_prob == 0.0 for c in b.candidates)
    if option == "greedy_in_pool":
        assert n_greedy > 0  # at least one greedy hypothesis passed the gates
    else:  # the banding took effect
        trg = jdp.collate([jdp.featurize(r, ModelConfig()) for r in jrecs]).trg_tokens
        assert th.banded_decode_len(trg, 64) < 64


def test_banded_decode_len_follows_the_jax_rule():
    """need = longest target (non-<PAD> tokens) - 1 + 12; the smallest of
    {40, 56} with need <= c < max_len, else max_len (JAX eval/harness.py)."""
    def trg(n_live: int) -> np.ndarray:
        row = np.zeros(64, np.int32)
        row[0], row[1:n_live - 1], row[n_live - 1] = tvocab.SOS_ID, 5, tvocab.EOS_ID
        return row

    for lengths, max_len, want in (([10, 29], 64, 40), ([30], 64, 56), ([45], 64, 56),
                                   ([46], 64, 64), ([10], 40, 40), ([10], 41, 40), ([30], 56, 56)):
        assert th.banded_decode_len(np.stack([trg(n) for n in lengths]), max_len) == want
