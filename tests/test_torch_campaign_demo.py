"""The real-data demo's parts (``scripts/torch_real_data_demo.py``) against
the JAX script's (``scripts/real_data_demo.py``) on the CPU; its whole run is
in ``test_torch_campaign_eval.py``.

Five molecules simulated with IR and written in the AZ example format are
loaded by each package. The folds take 2 steps at the script's lr at
``ModelConfig.small()`` in float32 with dropout off from one parameter tree
in both packages, arm 2 with JAX's
own jitter and warp draws fed to the port: the loss within 1e-5 relative,
the tensors that train within 1e-5 wherever every step's gradient is
resolved (the train step's bound; elsewhere AdamW turns rounding noise into
a step of about lr, see ``test_torch_train.py::test_train_steps_match_jax``)
and within 2 lr a step everywhere, the frozen ones bit-equal to the start in
both. ``trainable_only`` picks JAX's tensors; the per-molecule dicts and the
aggregation are equal on injected harness results; the measured sigmas
within 1e-5."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.eval import harness as tharness
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.train import loop as tloop
from multimodalspectraltransformer_torch.train import state as tstate
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.eval import harness as jharness
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.train import loop as jloop
from multimodalspectraltransformer_tpu.train import state as jstate
from multimodalspectraltransformer_tpu.train import step as jstep
from multimodalspectraltransformer_tpu.utils import config as jconfig
from torch_test_support import injected_evaluate, load, load_copy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(dropout=0.0)


@pytest.fixture(scope="module")
def demo_records(tmp_path_factory):
    """Five molecules simulated with IR, written in the AZ example format,
    as each package loads them."""
    d = str(tmp_path_factory.mktemp("az"))
    smiles = ["CCOC(=O)c1ccccc1", "CC(C)Cc1ccc(C(C)C(=O)O)cc1", "O=C(O)c1ccccc1O",
              "CCN(CC)CC(=O)Nc1c(C)cccc1C", "COc1ccc(CC(C)N)cc1"]
    recs = tfactory.simulate_records(smiles, sample_ids=[f"AZ{i}" for i in range(5)],
                                     device="cpu")
    chip_smoke.write_az_example(d, recs)
    return d, tdp.load_real_example(d), jdp.load_real_example(d)


@pytest.fixture(scope="module")
def small_params():
    """One small tree (dropout off): JAX's and the port's state dict of it."""
    cfg = jconfig.ModelConfig.small(**SMALL)
    params = jmmt.init_params(cfg, jax.random.PRNGKey(3))
    return params, tconvert.from_jax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("trainable", [("real_data_linear",), ("decoder", "fc_out", "real_data_linear"),
                                       ("decoder",), ("fc_out",)])
def test_trainable_selection_matches_jax(small_params, trainable):
    """The port's ``trainable_only`` picks the tensors of JAX's mask: the
    substring ``decoder`` takes the decoder's layers and nothing of another
    subtree."""
    params, sd = small_params
    mask = jstate._trainable_mask(jconfig.TrainConfig(trainable_only=trainable), params)
    want = tconvert.from_jax_params(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                                 mask, params))
    model = tmmt.MultimodalTransformer(tconfig.ModelConfig.small(**SMALL))
    model.load_state_dict(sd)
    picked = {id(p) for p in tstate.trainable_parameters(tconfig.TrainConfig(trainable_only=trainable),
                                                          model)}
    got = {n: id(p) in picked for n, p in model.named_parameters()}
    assert got == {n: bool(want[n].all()) for n in got}
    assert all(want[n].all() or not want[n].any() for n in got)
    assert any(got.values()) and not all(got.values())


def _jax_fold(params, records, held, mcfg, trainable, steps, lr, **extra):
    """The fold of ``scripts/real_data_demo.py::loo_arm``, in float32."""
    fold_train = [r for j, r in enumerate(records) if j != held]
    cfg = jconfig.MMTConfig(
        model=mcfg,
        train=jconfig.TrainConfig(learning_rate=lr, num_epochs=1000, trainable_only=trainable,
                                  save_interval_steps=10**9, mixed_precision=False, **extra),
        data=jconfig.DataConfig(batch_size=len(fold_train)))
    train_records = jdp.augment_records(fold_train, 8, seed=0)
    loader = jdp.Loader(train_records, mcfg, batch_size=min(16, len(train_records)), seed=0,
                        opts=jdp.FeaturizeOptions(use_given_smiles_form=True))
    return jloop.run_training(cfg, loader, init_params=params, max_steps=steps, log_every=50)


def _feed_jax_draws(monkeypatch) -> None:
    """JAX's warp and jitter run as they are; each call's draws, made from
    its key as JAX makes them, replace the port's next draws."""
    queue = {"warp": [], "jitter": []}
    real_jwarp, real_jjitter = jstep.warp_spectra_device, jstep.jitter_spectra_device
    real_twarp, real_tjitter = tloop.warp_spectra_device, tloop.jitter_spectra_device

    def jwarp(b, key, sigma_h, sigma_c, gate_p, **kw):
        ks = jax.random.split(key, 3)
        B = b.inputs.mw.shape[0]
        queue["warp"].append([jax.random.uniform(ks[0], (B,)), jax.random.normal(ks[1], (B, 6)),
                              jax.random.normal(ks[2], (B, 5))])
        return real_jwarp(b, key, sigma_h, sigma_c, gate_p, **kw)

    def jjitter(b, key, sigma_h, sigma_c, gate_p, **kw):
        ks = jax.random.split(key, 6)
        inp = b.inputs
        queue["jitter"].append([
            jax.random.uniform(ks[0], (inp.mw.shape[0],)),
            jax.random.normal(ks[1], inp.src_1h.shape[:2]), jax.random.normal(ks[2], inp.src_13c.shape),
            jax.random.normal(ks[3], inp.src_hsqc.shape[:2]),
            jax.random.normal(ks[4], inp.src_hsqc.shape[:2]), jax.random.normal(ks[5], inp.src_cosy.shape)])
        return real_jjitter(b, key, sigma_h, sigma_c, gate_p, **kw)

    def take(kind):
        return [torch.from_numpy(np.asarray(d)) for d in queue[kind].pop(0)]

    monkeypatch.setattr(jstep, "warp_spectra_device", jwarp)
    monkeypatch.setattr(jstep, "jitter_spectra_device", jjitter)
    monkeypatch.setattr(tloop, "warp_spectra_device",
                        lambda b, gen, h, c, p, shard=None: real_twarp(b, None, h, c, p,
                                                                       noise=take("warp"), shard=shard))
    monkeypatch.setattr(tloop, "jitter_spectra_device",
                        lambda b, gen, h, c, p, shard=None: real_tjitter(b, None, h, c, p,
                                                                         noise=take("jitter"), shard=shard))
    return queue


LR = 5e-5  # the script's --lr
ARMS = {
    "blend_head": (("real_data_linear",), {}),
    "decoder_blend_jitter_matched": (("decoder", "fc_out", "real_data_linear"),
                                     dict(jitter_13c_ppm=3.1, jitter_1h_ppm=0.21, jitter_gate_p=0.5,
                                          warp_13c_ppm=3.1, warp_1h_ppm=0.21)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_fold_matches_jax(demo_records, small_params, monkeypatch, arm):
    """One fold (the second molecule held out), 2 steps at the script's lr."""
    _, trecs, jrecs = demo_records
    params, sd = small_params
    trainable, extra = ARMS[arm]
    queue = _feed_jax_draws(monkeypatch)
    jcfg = dataclasses.replace(jconfig.ModelConfig.small(**SMALL), use_real_data=True)
    tcfg = dataclasses.replace(tconfig.ModelConfig.small(**SMALL), use_real_data=True)
    ref = _jax_fold(params, jrecs, 1, jcfg, trainable, 2, LR, **extra)
    grads = []  # each step's gradients, for where they are resolved
    real_step = tloop.train_step

    def recording_step(*a, **k):
        state, m = real_step(*a, **k)
        grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()
                      if p.grad is not None})
        return state, m

    monkeypatch.setattr(tloop, "train_step", recording_step)
    got = load("scripts/torch_real_data_demo.py").train_fold(
        sd, trecs, 1, tcfg, trainable, 2, LR, mixed_precision=False, device="cpu", **extra)
    if extra:
        assert queue == {"warp": [], "jitter": []}  # every JAX draw went to the port
    assert got.steps == ref.steps == 2
    assert got.train_loss == pytest.approx(ref.train_loss, rel=1e-5)
    moved = {id(p) for p in tstate.trainable_parameters(
        tconfig.TrainConfig(trainable_only=trainable), got.state.model)}
    want = tconvert.from_jax_params(jax.tree.map(np.asarray, ref.state.params))
    n_moved = 0
    for name, p in got.state.model.named_parameters():
        start, ref_p, ours = sd[name], want[name], p.detach()
        if id(p) not in moved:
            assert torch.equal(ours, start), name  # frozen: bit-equal in both
            assert torch.equal(ref_p, start), name
            continue
        resolved = torch.ones_like(ours, dtype=torch.bool)
        for step in grads:
            g = step[name].abs()
            resolved &= (g >= 1e-4 * g.max()) & (g >= 1e-6)
        assert float((ours - ref_p)[resolved].abs().max()) <= 1e-5 if resolved.any() else True, name
        assert float((ours - ref_p).abs().max()) <= 2 * 2 * LR, name
        n_moved += int((ours != start).any())
    assert n_moved == len(moved) and len(grads) == 2


def test_evaluate_and_agg_match_jax_on_injected_results(tmp_path, demo_records, small_params,
                                                      monkeypatch):
    """The per-molecule dicts (the ranking by error included) and the fold
    aggregation, from the same injected harness results."""
    _, trecs, jrecs = demo_records
    params, sd = small_params
    port = load("scripts/torch_real_data_demo.py")
    jax_demo = load_copy("scripts/real_data_demo.py", str(tmp_path))
    monkeypatch.setattr(jharness, "evaluate_molecules", injected_evaluate(jharness, []))
    monkeypatch.setattr(tharness, "evaluate_molecules", injected_evaluate(tharness, []))
    want_mols, want_sum = jax_demo.evaluate(jrecs, params, jconfig.ModelConfig.small(**SMALL),
                                            jconfig.DecodeConfig(max_len=64, fanout=4))
    model = tmmt.MultimodalTransformer(tconfig.ModelConfig.small(**SMALL))
    model.load_state_dict(sd)
    got_mols, got_sum = port.evaluate(trecs, model, tconfig.DecodeConfig(max_len=64, fanout=4),
                                      device="cpu")
    assert got_mols == want_mols and len(got_mols) == 5
    assert port.agg(got_mols) == jax_demo.agg(want_mols)
    assert (got_sum.greedy_exact, got_sum.mns_exact) == (want_sum.greedy_exact, want_sum.mns_exact)


def test_measured_sigma_matches_jax(tmp_path, demo_records):
    _, trecs, jrecs = demo_records
    got = load("scripts/torch_real_data_demo.py").measured_sigma(trecs, "cpu")
    want = load_copy("scripts/real_data_demo.py", str(tmp_path)).measured_sigma(jrecs)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
