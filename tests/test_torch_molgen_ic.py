"""The port's molecule generator and self-improvement cycle against the JAX
package.

The generator's host part is the same Python seeded the same way, so its
molecules must be identical. The model part samples with the port's own
generator, so it is held to determinism and to JAX's acceptance filters. One
improvement cycle from converted JAX parameters (dropout 0, float32) must
give JAX's augmentation count, its training loss within 1e-4 relative (float32
sums in another order over two steps), and its teacher-forced sequence
probability and greedy exact rate within 1e-4."""

from __future__ import annotations

import dataclasses
import os
import random

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.chem.smiles import parse_smiles as tparse
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.train import improvement_cycle as tic
from multimodalspectraltransformer_torch.train import molgen as tmolgen
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.chem import api as jchem
from multimodalspectraltransformer_tpu.chem.smiles import parse_smiles as jparse
from multimodalspectraltransformer_tpu.data import molrandom
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.sim import factory as jfactory
from multimodalspectraltransformer_tpu.train import improvement_cycle as jic
from multimodalspectraltransformer_tpu.train import molgen as jmolgen
from multimodalspectraltransformer_tpu.utils import config as jconfig


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
TARGETS = molrandom.random_corpus(20, seed=77)[:8] + ["CC(C)Cc1ccc(C(C)C(=O)O)cc1",
                                                     "CC(=O)Nc1ccc(O)cc1"]
TINY = dict(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=128, dropout=0.0)


def _configs(seed: int):
    kw = dict(generations_per_target=12, max_trials=150, seed=seed)
    return jmolgen.MolGenConfig(**kw), tmolgen.MolGenConfig(**kw)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_neighbors_identical_to_jax(seed):
    jcfg, tcfg = _configs(seed)
    ours = tmolgen.generate_for_targets(TARGETS, tcfg)
    assert ours == jmolgen.generate_for_targets(TARGETS, jcfg)
    assert sum(len(v) for v in ours.values()) > 5 * len(TARGETS)
    for t in TARGETS[:3]:
        assert tmolgen.generate_neighbors(t, tcfg) == ours[t]
    pool = [s for v in ours.values() for s in v]
    assert tmolgen.pool_diversity(pool) == jmolgen.pool_diversity(pool)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_mutate_identical_to_jax(seed):
    """Every mutation operator draws the same numbers and writes the same
    SMILES: 200 mutations of each of four molecules, one Random each side."""
    rj, rt = random.Random(seed), random.Random(seed)
    for smi in ("CCCCCC", "C1CCCCC1", "CC(=O)Nc1ccc(O)cc1", "OCC(Cl)c1ccncc1"):
        jm, tm = jparse(smi), tparse(smi)
        ours = [tmolgen.mutate(tm, rt) for _ in range(200)]
        assert ours == [jmolgen.mutate(jm, rj) for _ in range(200)]
        assert len({s for s in ours if s}) > 10


def test_filter_neighbor_pool_identical_to_jax():
    """The same candidate list (neighbors of two seeds, the target itself,
    duplicates and invalid strings) through both filters."""
    can = jchem.canonicalize("CC(C)Cc1ccc(C(C)C(=O)O)cc1")
    mw = jchem.mol_wt(can)
    smiles = [can, "not a smiles", "C(("]
    for seed in (0, 1):
        smiles += tmolgen.generate_neighbors(can, tmolgen.MolGenConfig(seed=seed))
    smiles += smiles[3:10]
    for kw in ({}, dict(generations_per_target=5), dict(max_per_scaffold=2, lipinski=False)):
        ours = tmolgen._filter_neighbor_pool(smiles, can, mw, tmolgen.MolGenConfig(**kw))
        assert ours == jmolgen._filter_neighbor_pool(smiles, can, mw, jmolgen.MolGenConfig(**kw))
        assert ours and can not in ours


def _jax_params(mcfg):
    return jmmt.init_params(mcfg, jax.random.PRNGKey(0))


def test_sample_model_neighbors_batch_deterministic_and_filtered():
    """With the phase3 weights (an untrained model accepts nothing): the same
    lists for the same seed, one per record in order, some neighbors
    accepted, and every accepted neighbor passes JAX's filters replayed in
    the port's order (the scaffold counts too)."""
    model = tmmt.load_model(PHASE3, tconfig.ModelConfig(), "cpu")
    cfg = tmolgen.MolGenConfig(generations_per_target=5, mw_delta=30.0, tanimoto_min=0.05,
                               lipinski=False)
    records = tfactory.simulate_records(["CCOC(=O)c1ccccc1", "CC(C)Cc1ccc(C(C)C(=O)O)cc1",
                                         "CCN"], device="cpu")
    run = lambda seed: tmolgen.sample_model_neighbors_batch(
        model, records, dataclasses.replace(cfg, seed=seed), fanout=16, max_rounds=1, chunk=2,
        device="cpu")
    outs = run(0)
    assert outs == run(0) and len(outs) == len(records)
    assert sum(len(o) for o in outs) >= 3
    jcfg = jmolgen.MolGenConfig(**dataclasses.asdict(cfg))
    for rec, out in zip(records, outs):
        can = jchem.canonicalize(rec.smiles)
        counts: dict = {}
        for smi in out:
            assert smi != can and jchem.canonicalize(smi) == smi
            assert jmolgen._passes_filters(smi, can, jchem.mol_wt(can), jcfg, counts)
    single = tmolgen.sample_model_neighbors(model, records[0].smiles, cfg, fanout=16,
                                            max_rounds=1, record=records[0], device="cpu")
    assert single == tmolgen.sample_model_neighbors(model, records[0].smiles, cfg, fanout=16,
                                                    max_rounds=1, record=records[0], device="cpu")


def test_improvement_cycle_matches_jax():
    """Two cycles, two steps each, from converted JAX parameters with dropout
    0 in float32, on the same target records: per cycle the augmentation
    count equal, the training loss within 1e-4 relative, corr_sampling_prob
    and greedy_exact within 1e-4, and the log of corr_sampling_prob within
    1e-3 (the probabilities are near 4e-5 here: a product of about ten token
    probabilities, each a few 1e-5 off after two float32 steps, agreeing to
    about 3e-4 relative). ``on_cycle`` sees every report; ``should_stop``
    ends the run before a cycle."""
    jm = jconfig.ModelConfig(**TINY)
    kw = dict(max_cycles=2, ic_threshold=2.0, steps_per_cycle=2,
              include_targets_in_training=True)
    mg = dict(generations_per_target=4, max_trials=60)
    jcfg = jconfig.MMTConfig(model=jm, train=jconfig.TrainConfig(
        learning_rate=1e-3, num_epochs=1, save_interval_steps=10_000),
        data=jconfig.DataConfig(batch_size=8))
    tcfg = tconfig.MMTConfig(model=tconfig.ModelConfig(**TINY), train=tconfig.TrainConfig(
        learning_rate=1e-3, num_epochs=1, save_interval_steps=10_000),
        data=tconfig.DataConfig(batch_size=8))
    jtargets = jfactory.simulate_records(["CCO", "CCN", "CCC(=O)O"], ["t0", "t1", "t2"])
    ttargets = [tdp.SampleRecord(**dataclasses.asdict(r)) for r in jtargets]
    params = _jax_params(jm)
    _, jreports = jic.run_improvement_cycle(
        jcfg, jtargets, params, jic.ImprovementCycleConfig(molgen=jmolgen.MolGenConfig(**mg), **kw))
    seen = []
    init = tconvert.from_jax_params(params)
    before = {k: v.clone() for k, v in init.items()}
    out, reports = tic.run_improvement_cycle(
        tcfg, ttargets, init, tic.ImprovementCycleConfig(molgen=tmolgen.MolGenConfig(**mg), **kw),
        seed=0, on_cycle=seen.append, device="cpu")
    assert [r.cycle for r in reports] == [r.cycle for r in jreports] == [0, 1]
    assert seen == reports
    for ours, ref in zip(reports, jreports):
        assert ours.n_augmented == ref.n_augmented > 0
        np.testing.assert_allclose(ours.train_loss, ref.train_loss, rtol=1e-4)
        for key in ("corr_sampling_prob", "greedy_exact"):
            np.testing.assert_allclose(getattr(ours.summary, key), getattr(ref.summary, key),
                                       rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.log(ours.summary.corr_sampling_prob),
                                   np.log(ref.summary.corr_sampling_prob), rtol=0, atol=1e-3)
        assert set(ours.stage_seconds) == {"molgen", "simulate", "train", "evaluate"}
    assert all(torch.equal(before[k], init[k]) for k in init)  # the caller's state dict stays
    assert any(not torch.equal(out[k], init[k]) for k in init)
    stopped, none = tic.run_improvement_cycle(tcfg, ttargets, init, should_stop=lambda: True,
                                              device="cpu")
    assert none == [] and stopped is init
