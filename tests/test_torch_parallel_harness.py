"""The sharded harness and the multi-rank dry run of the port on the CPU.

``evaluate_molecules(mesh=...)`` over 2 and 8 gloo ranks (``parallel/
launch.py``; the ranks run ``tests/torch_parallel_ranks.py``, which imports no
JAX) against the port's one-process run on the same records: greedy decodes
token-identical, every molecule's candidate set equal, ``corr_sampling_prob``
within 1e-4 relative (each rank's teacher-forced pass has other row counts);
6 molecules over 8 ranks pad and trim. The greedy decodes also equal the JAX
harness run with ``mesh=`` on its 8-device virtual mesh, as
``tests/test_multislice.py`` runs it. Then ``dryrun_multichip`` on 4 and 8
ranks.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.chem import api as tchem
from multimodalspectraltransformer_torch.eval import harness as th
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.parallel.dryrun import dryrun_multichip
from multimodalspectraltransformer_torch.parallel.launch import launch
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu import parallel as jpar
from multimodalspectraltransformer_tpu.eval import harness as jh
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.sim import factory as jfactory
from multimodalspectraltransformer_tpu.utils.config import DecodeConfig, ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
SMILES = ["CCO", "CC(C)=O", "Cc1ccccc1", "CCN", "CC(N)C(=O)O", "c1ccncc1", "CCOC(C)=O", "CC(O)CC"]
MCFG = ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64)
TCFG = tconfig.ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64)
# two rounds, so the second packs the unsatisfied molecules of every rank
DCFG = dict(max_len=12, fanout=4, multinom_runs=2, max_temp_rounds=2, mw_filter=False)
# phase3 at full width on the GNN's spectra: 2-4 candidates a molecule, three
# rounds for every one, injected candidates
P3_DCFG = dict(max_len=40, fanout=8, multinom_runs=4, max_temp_rounds=3, round_shrink=False,
               mw_filter=False)
CASES = {"8_over_2": (8, 2), "8_over_8": (8, 8), "6_over_8": (6, 8)}


def _tdcfg(**kw) -> tconfig.DecodeConfig:
    return tconfig.DecodeConfig(**{**kw, "round_shrink": False})


@pytest.fixture(scope="module")
def records():
    return tfactory.simulate_records(SMILES, use_default_models=False, device="cpu")


@pytest.fixture(scope="module")
def gnn_records():
    return tfactory.simulate_records(SMILES, device="cpu")


@pytest.fixture(scope="module")
def params():
    return jmmt.init_params(MCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def sharded(records, gnn_records, params):
    """Every case's sharded run: one launch of 2 ranks (with phase3 at full
    width and injected candidates) and one of 8."""
    sd = {k: v.numpy() for k, v in tconvert.from_jax_params(params).items()}
    extras = [[SMILES[(i + 3) % 8]] for i in range(8)]
    two = [("evaluate", ((None, 2, 1), TCFG, sd, records, _tdcfg(**DCFG), 9), {}),
           ("evaluate", ((None, 2, 1), tconfig.ModelConfig(), PHASE3, gnn_records,
                         tconfig.DecodeConfig(**P3_DCFG), 4), dict(extra_candidates=extras))]
    eight = [("evaluate", ((None, 8, 1), TCFG, sd, records[:n], _tdcfg(**DCFG), 9), {})
             for n in (8, 6)]
    return dict(two=launch("torch_parallel_ranks:jobs", 2, args=(two,), device="cpu"),
                eight=launch("torch_parallel_ranks:jobs", 8, args=(eight,), device="cpu"),
                sd=sd, extras=extras)


def _same(ref: list, ref_sum, got: dict):
    res, summary = got["results"], got["summary"]
    assert len(res) == len(ref)
    assert [r.greedy for r in res] == [r.greedy for r in ref]
    assert [sorted(c.smiles for c in r.candidates) for r in res] == [
        sorted(c.smiles for c in r.candidates) for r in ref]
    assert [r.sampling_rounds for r in res] == [r.sampling_rounds for r in ref]
    assert [r.corr_sampling_prob for r in res] == pytest.approx(
        [r.corr_sampling_prob for r in ref], rel=1e-4)
    assert summary.n == ref_sum.n
    assert summary.greedy_tanimoto == pytest.approx(ref_sum.greedy_tanimoto)
    assert summary.top_k_accuracy == pytest.approx(ref_sum.top_k_accuracy)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_harness_matches_one_process(records, sharded, case):
    n, ranks = CASES[case]
    model = tmmt.MultimodalTransformer(TCFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sharded["sd"].items()})
    ref, ref_sum = th.evaluate_molecules(records[:n], model, _tdcfg(**DCFG), seed=9,
                                         device="cpu", sim_kwargs=dict(use_default_models=False))
    outs = sharded["two"] if ranks == 2 else sharded["eight"]
    job = 0 if ranks == 2 else (8, 6).index(n)
    for o in outs:  # every rank holds every result
        _same(ref, ref_sum, o[job])


def test_sharded_harness_with_phase3_matches_one_process(gnn_records, sharded):
    """Phase3 at full width over 2 ranks, three rounds without round-shrink on
    both sides, injected candidates: the candidates of one process, and each
    injected candidate with the molecule it was given for."""
    model = tmmt.load_model(PHASE3, tconfig.ModelConfig(), "cpu")
    ref, ref_sum = th.evaluate_molecules(gnn_records, model, tconfig.DecodeConfig(**P3_DCFG), seed=4,
                                         device="cpu", sim_kwargs=dict(use_default_models=False),
                                         extra_candidates=sharded["extras"])
    assert sum(len(r.candidates) for r in ref) > 2 * len(ref)
    assert all(r.sampling_rounds == 3 for r in ref)
    for o in sharded["two"]:
        _same(ref, ref_sum, o[1])
        for r, extra in zip(o[1]["results"], sharded["extras"]):
            assert tchem.canonicalize(extra[0]) in {c.smiles for c in r.candidates}


@pytest.mark.parametrize("n", [8, 6])
def test_sharded_harness_greedy_matches_jax_mesh(params, sharded, n):
    """Token for token with the JAX harness over its (data 8) virtual mesh."""
    jrecs = jfactory.simulate_records(SMILES[:n], use_default_models=False)
    jdcfg = DecodeConfig(**DCFG, lookahead=False)
    mesh = jpar.make_mesh(data=8, model=1)
    jres, _ = jh.evaluate_molecules(jrecs, params, MCFG, jdcfg, jax.random.PRNGKey(9), mesh=mesh)
    got = sharded["eight"][0][(8, 6).index(n)]["results"]
    assert [r.greedy for r in got] == [r.greedy for r in jres]
    assert [r.target for r in got] == [r.target for r in jres]


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip(n_devices, capsys):
    line = dryrun_multichip(n_devices, device="cpu")
    assert line.startswith("dryrun_multichip ok: mesh axes=")
    assert ("('dcn', 'data', 'model')" in line) == (n_devices % 8 == 0)
    assert line in capsys.readouterr().out
