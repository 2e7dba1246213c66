"""The port's training path against the JAX package's, on the CPU.

The same numpy-seeded batches and the same parameters go through both, at a
small width (2+2 layers, d_model 32) and once at full width with phase3; JAX
runs at "highest" matmul precision (tests/conftest.py). Tolerances:

- fp32 forward and loss (dropout off): 1e-5 relative;
- gradients: every leaf within 1e-4 of its own largest magnitude;
- parameters after three AdamW applications of the same gradients: 1e-6
  absolute; after three whole train steps, 1e-6 wherever the gradient is
  resolved in float32 (``test_train_steps_match_jax`` says why not
  everywhere);
- the bfloat16 mixed-precision loss against JAX's compiled bfloat16 loss:
  2e-3 relative. The two round to bfloat16 at different places (XLA's
  fusions drop some roundings): measured 3.8e-4 at the small width and
  8.2e-4 at full width with phase3, where JAX's compiled and op-by-op losses
  differ by 3.1e-3 and the float32 loss lies 4.1e-3 away;
- the batch transforms and scheduled sampling, fed JAX's own random draws:
  1e-6 absolute (exact where no arithmetic is involved).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import layers as tlayers
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.train import loop as tloop
from multimodalspectraltransformer_torch.train import loss as tloss
from multimodalspectraltransformer_torch.train import state as tstate
from multimodalspectraltransformer_torch.train import step as tstep
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.train import checkpoint as jckpt
from multimodalspectraltransformer_tpu.train import loop as jloop
from multimodalspectraltransformer_tpu.train import loss as jloss
from multimodalspectraltransformer_tpu.train import state as jstate
from multimodalspectraltransformer_tpu.train import step as jstep
from multimodalspectraltransformer_tpu.utils.config import (MMTConfig, ModalityConfig, ModelConfig,
                                                            TrainConfig)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
SMALL = dict(hidden_size=32, num_heads=4, cross_num_heads=4, num_encoder_layers=2,
             num_decoder_layers=2, ffn_dim=64)
VARIANTS = {
    "all": {},
    "no_cosy_blank65": {"modalities": ModalityConfig(use_cosy=False)},
    "ms_hint": {"modalities": ModalityConfig(use_ms=True)},
    "real_data_blend": {"use_real_data": True},
}


def _torch_cfg(cfg: MMTConfig) -> tconfig.MMTConfig:
    """The same configuration as the port's own dataclasses."""
    m = cfg.model
    mods = tconfig.ModalityConfig(**dataclasses.asdict(m.modalities))
    fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m) if f.name != "modalities"}
    return tconfig.MMTConfig(model=tconfig.ModelConfig(modalities=mods, **fields),
                             train=tconfig.TrainConfig(**dataclasses.asdict(cfg.train)))


def _cfg(dropout: float = 0.0, model: dict | None = None, **train) -> MMTConfig:
    train = {"learning_rate": 1e-3, "weight_fp": 0.1, **train}
    return MMTConfig(model=ModelConfig(**SMALL, dropout=dropout, **(model or {})),
                     train=TrainConfig(**train))


def _batches(cfg: ModelConfig, n: int = 4, seed: int = 0):
    """The same featurized batch for JAX (jnp) and the port (CPU tensors)."""
    recs = jdp.synthetic_dataset(n, seed=seed)
    nb = jdp.collate([jdp.featurize(r, cfg) for r in recs])
    jb = jax.tree.map(jnp.asarray, nb)
    tb = tdp.to_device(tdp.TrainBatch(tmmt.MMTBatch(*nb.inputs), nb.trg_tokens, nb.trg_fp), "cpu")
    return jb, tb


def _models(cfg: MMTConfig, params):
    tmodel = tmmt.MultimodalTransformer(_torch_cfg(cfg).model)
    tmodel.load_state_dict(tconvert.from_jax_params(params))
    return jmmt.MultimodalTransformer(cfg.model), tmodel


def _grads(tmodel) -> dict[str, np.ndarray]:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in tmodel.named_parameters()}


def _assert_close_rel(a, b, rtol, what=""):
    assert abs(float(a) - float(b)) <= rtol * max(abs(float(b)), 1e-12), (what, float(a), float(b))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_forward_loss_and_grads_match_jax(variant):
    cfg = _cfg(model=VARIANTS[variant])
    params = jmmt.init_params(cfg.model, jax.random.PRNGKey(1))
    jmodel, tmodel = _models(cfg, params)
    jb, tb = _batches(cfg.model)
    (jtotal, (jout, jacc)), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        params, jmodel, cfg, jb, jax.random.PRNGKey(0))
    tmodel.train()
    ttotal, (tout, tacc) = tstep.loss_fn(tmodel, _torch_cfg(cfg), tb)
    ttotal.backward()
    for name, a, b in (("total", ttotal, jtotal), ("smi", tout.smi_loss, jout.smi_loss),
                       ("fp", tout.fp_loss, jout.fp_loss)):
        _assert_close_rel(a.detach(), b, 1e-5, name)
    assert float(tacc) == pytest.approx(float(jacc), abs=1e-6)
    ref = tconvert.from_jax_params(jgrads)
    got = _grads(tmodel)
    assert set(ref) == set(got)
    for name, g in ref.items():
        g = g.numpy()
        scale = max(np.abs(g).max(), 1e-12)
        np.testing.assert_allclose(got[name], g, atol=1e-4 * scale, rtol=0, err_msg=name)


def test_training_forward_matches_jax_phase3():
    """Full width, phase3 weights, fp32, dropout off: logits, fingerprint and
    the loss."""
    cfg = MMTConfig(model=ModelConfig(dropout=0.0), train=TrainConfig(weight_fp=0.1))
    params = jckpt.import_params_msgpack(jmmt.init_params(cfg.model, jax.random.PRNGKey(0)), PHASE3)
    jmodel, tmodel = _models(cfg, params)
    jb, tb = _batches(cfg.model, n=2, seed=4)
    jtotal, (jout, _) = jstep.loss_fn(params, jmodel, cfg, jb, jax.random.PRNGKey(0))
    jlogits, jfp, _, _ = jmodel.apply({"params": params}, jb.inputs, jb.trg_tokens[:, :-1], True)
    tmodel.train()
    with torch.no_grad():
        ttotal, (tout, _) = tstep.loss_fn(tmodel, _torch_cfg(cfg), tb)
        tlogits, tfp, _, _ = tmodel(tb.inputs, tb.trg_tokens[:, :-1])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4)
    np.testing.assert_allclose(tfp.numpy(), np.asarray(jfp), atol=1e-4)
    _assert_close_rel(ttotal, jtotal, 1e-5, "total")
    _assert_close_rel(tout.fp_loss, jout.fp_loss, 1e-5, "fp")


@pytest.mark.parametrize("width", ["small", "phase3"])
def test_bf16_mixed_precision_loss_matches_jax_compiled(width):
    """The bfloat16 loss (float32 master weights) against JAX's jitted bf16
    loss_fn, within 2e-3 relative (see the module docstring); the port's
    float32 loss differs from it, so the bf16 path ran."""
    if width == "small":
        cfg = _cfg(mixed_precision=True)
        params = jmmt.init_params(cfg.model, jax.random.PRNGKey(1))
        jb, tb = _batches(cfg.model)
    else:
        cfg = MMTConfig(model=ModelConfig(dropout=0.0),
                        train=TrainConfig(weight_fp=0.1, mixed_precision=True))
        params = jckpt.import_params_msgpack(jmmt.init_params(cfg.model, jax.random.PRNGKey(0)),
                                             PHASE3)
        jb, tb = _batches(cfg.model, n=2, seed=4)
    jmodel, tmodel = _models(cfg, params)
    loss = jax.jit(lambda p, b: jstep.loss_fn(p, jmodel, cfg, b, jax.random.PRNGKey(0))[0])
    jtotal = float(loss(params, jb))
    tmodel.train()
    tcfg = _torch_cfg(cfg)
    with torch.no_grad():
        ttotal = float(tstep.loss_fn(tmodel, tcfg, tb)[0])
        t32 = float(tstep.loss_fn(tmodel, dataclasses.replace(
            tcfg, train=dataclasses.replace(tcfg.train, mixed_precision=False)), tb)[0])
    _assert_close_rel(ttotal, jtotal, 2e-3, "bf16 total")
    assert ttotal != t32
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 43)).astype(np.float32)
    trg = rng.integers(0, 43, size=(3, 8))
    trg[:, 5:] = 0
    z = rng.normal(size=(3, 512)).astype(np.float32)
    y = (rng.random((3, 512)) < 0.2).astype(np.float32)
    for pad_aware in (False, True):
        a = tloss.total_loss(torch.from_numpy(logits), torch.from_numpy(trg), torch.from_numpy(z),
                             torch.from_numpy(y), 1.0, 0.3, pad_aware, 0.25)
        b = jloss.total_loss(jnp.asarray(logits), jnp.asarray(trg), jnp.asarray(z), jnp.asarray(y),
                             1.0, 0.3, pad_aware, 0.25)
        for x, r in zip(a, b):
            _assert_close_rel(x, r, 1e-6, f"pad_aware={pad_aware}")


# ---------------------------------------------------------------------------
# AdamW, the plateau and the train step
# ---------------------------------------------------------------------------

def _random_grads(params, seed: int):
    """A gradient tree for ``params``: normal draws of mixed scales, with the
    real_data_linear bias zero (the port leaves it without a gradient) and
    the fc_out kernel's first column zero."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    gs = [rng.normal(size=np.shape(x)).astype(np.float32) * 10.0 ** rng.integers(-4, 1)
          for x in leaves]
    grads = jax.tree_util.tree_unflatten(treedef, gs)
    grads["real_data_linear"]["bias"][:] = 0.0
    grads["fc_out"]["kernel"][:, 0] = 0.0
    return grads


@pytest.mark.parametrize("case", ["plain", "trainable_only", "plateau"])
def test_adamw_and_plateau_match_optax(case):
    """The same gradients through JAX's ``apply_grads`` (optax adamw, the
    plateau scale, the trainable mask) and the port's: parameters within
    1e-6 after three applications; frozen leaves bit-equal to their start; a
    plateau reduction between epochs (patience 0) halves the rate in both."""
    cfg = _cfg(learning_rate=1e-2, weight_decay=0.05,
               trainable_only=("real_data_linear", "fc_out", "decoder/layers_1")
               if case == "trainable_only" else (),
               plateau_patience=0 if case == "plateau" else 2)
    tcfg = _torch_cfg(cfg)
    params = jmmt.init_params(cfg.model, jax.random.PRNGKey(1))
    _, tmodel = _models(cfg, params)
    init = {k: v.clone() for k, v in tmodel.state_dict().items()}
    js = jstate.create_state(cfg.train, params)
    ts = tstate.create_state(tcfg.train, tmodel)
    schedule = [0, 5.0, 1, 6.0, 2] if case == "plateau" else [0, 1, 2]
    for item in schedule:
        if isinstance(item, float):
            js = jstate.update_plateau(cfg.train, js, item)
            ts = tstate.update_plateau(tcfg.train, ts, item)
            continue
        grads = _random_grads(params, item)
        js = jstate.apply_grads(cfg.train, js, grads, jnp.zeros(()))
        tg = tconvert.from_jax_params(grads)
        for name, p in tmodel.named_parameters():
            p.grad = None if name == "real_data_linear.bias" else tg[name].clone()
        ts = tstate.apply_grads(tcfg.train, ts)
    ref = tconvert.from_jax_params(js.params)
    paths = tconvert.jax_paths(init)
    moved = 0
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
        if case == "trainable_only" and not any(s in paths[name] for s in cfg.train.trainable_only):
            assert torch.equal(p, init[name]), name
        moved += not torch.equal(p, init[name])
    assert moved >= (20 if case == "trainable_only" else 100), moved
    assert ts.step == int(js.step) == 3
    jp = js.opt_state[1]
    assert (float(ts.plateau.best), ts.plateau.bad_count, float(ts.plateau.scale)) == (
        float(jp.best), int(jp.bad_count), float(jp.scale))
    assert float(ts.plateau.scale) == (0.5 if case == "plateau" else 1.0)


def test_train_steps_match_jax():
    """Three whole train steps (dropout off) in both packages: the loss, the
    token accuracy and the gradient norm of each step, and the parameters
    after them within 1e-6 wherever the gradient is resolved at every step:
    zero, or at least 1e-4 of its leaf's largest magnitude (the gradient
    test's bound) and 100 times AdamW's eps, or zero in both packages
    (chip_smoke.py's ``resolved_gradient``). Elsewhere AdamW turns float32 rounding noise into
    an update of size ~lr with either sign: the key bias of every attention,
    whose gradient is zero in exact arithmetic (softmax ignores a constant
    added to every score), and weights of rarely active feed-forward units.
    Those stay within 3 lr and are under 5% of the parameters."""
    cfg = _cfg()
    params = jmmt.init_params(cfg.model, jax.random.PRNGKey(1))
    jmodel, tmodel = _models(cfg, params)
    jb, tb = _batches(cfg.model)
    tcfg = _torch_cfg(cfg)
    js = jstate.create_state(cfg.train, jax.tree.map(jnp.array, params))
    ts = tstate.create_state(tcfg.train, tmodel)
    grad_fn = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(p, jmodel, cfg, b,
                                                            jax.random.PRNGKey(0))[0]))
    resolved = None
    for _ in range(3):
        g = tconvert.from_jax_params(grad_fn(js.params, jb))
        js, jm = jstep.train_step(jmodel, cfg, js, jb, jax.random.PRNGKey(0))
        ts, tm = tstep.train_step(tcfg, ts, tb)
        tgrads = {k: p.grad for k, p in ts.model.named_parameters()}
        ok = {k: chip_smoke.resolved_gradient(v, tgrads[k]) for k, v in g.items()}
        resolved = ok if resolved is None else {k: resolved[k] & ok[k] for k in ok}
        _assert_close_rel(tm.loss, jm.loss, 1e-5, "loss")
        _assert_close_rel(tm.grad_norm, jm.grad_norm, 1e-4, "grad norm")
        assert float(tm.token_accuracy) == pytest.approx(float(jm.token_accuracy), abs=1e-6)
    ref = tconvert.from_jax_params(js.params)
    n_all = n_unresolved = 0
    for name, p in ts.model.state_dict().items():
        diff = (p - ref[name]).abs()
        r = resolved[name]
        assert float(diff[r].max()) <= 1e-6 if r.any() else True, name
        assert float(diff.max()) <= 3 * cfg.train.learning_rate, name
        n_all += p.numel()
        n_unresolved += int((~r).sum())
    assert n_unresolved < 0.05 * n_all, (n_unresolved, n_all)


def test_plateau_step_matches_jax():
    losses = [5.0, 4.0, 4.0, 3.9999, 4.5, 4.5, 4.5, 2.0, 2.0, 2.0, 2.0]
    jp = jstate.PlateauState(jnp.asarray(jnp.inf, jnp.float32), jnp.zeros((), jnp.int32),
                             jnp.ones((), jnp.float32))
    tp = tstate.PlateauState()
    for x in losses:
        jp = jstate.plateau_step(jp, jnp.asarray(x, jnp.float32), 0.5, 2)
        tp = tstate.plateau_step(tp, x, 0.5, 2)
        assert (float(tp.best), tp.bad_count, float(tp.scale)) == (
            float(jp.best), int(jp.bad_count), float(jp.scale))


def test_anneal_weights_match_jax():
    cfg = MMTConfig(train=TrainConfig(change_loss_weights=True, batch_frequency=10,
                                      increment=0.2, weight_mw=1.0, weight_sgnn=0.5))
    tcfg = _torch_cfg(cfg)
    for step in (0, 9, 10, 55, 10_000):
        assert tloop.anneal_weights(step, tcfg) == jloop.anneal_weights(step, cfg)


# ---------------------------------------------------------------------------
# batch transforms and scheduled sampling, fed JAX's own draws
# ---------------------------------------------------------------------------

def _transform_batches():
    cfg = ModelConfig(**SMALL)
    recs = jdp.synthetic_dataset(6, seed=3)
    recs[1].cosy = None
    recs[2].ir = None
    recs[2].hsqc = None
    return _batches_from(cfg, recs)


def _batches_from(cfg, recs):
    nb = jdp.collate([jdp.featurize(r, cfg) for r in recs])
    jb = jax.tree.map(jnp.asarray, nb)
    tb = tdp.to_device(tdp.TrainBatch(tmmt.MMTBatch(*nb.inputs), nb.trg_tokens, nb.trg_fp), "cpu")
    return jb, tb


def _assert_inputs_close(tb, jb, atol):
    for name, a, b in zip(jb.inputs._fields, tb.inputs, jb.inputs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("p", [0.3, 0.9])
def test_blank_modalities_matches_jax(p):
    jb, tb = _transform_batches()
    key = jax.random.PRNGKey(11)
    ref = jstep.blank_modalities_device(jb, key, p)
    got = tstep.blank_modalities_device(tb, p, uniform=torch.from_numpy(
        np.asarray(jax.random.uniform(key, (6, 5)))))
    _assert_inputs_close(got, ref, 0.0)


def test_jitter_spectra_matches_jax():
    jb, tb = _transform_batches()
    key = jax.random.PRNGKey(5)
    ref = jstep.jitter_spectra_device(jb, key, 0.4, 2.5, 0.6)
    ks = jax.random.split(key, 6)
    inp = jb.inputs
    draws = (jax.random.uniform(ks[0], (6,)), jax.random.normal(ks[1], inp.src_1h.shape[:2]),
             jax.random.normal(ks[2], inp.src_13c.shape), jax.random.normal(ks[3], inp.src_hsqc.shape[:2]),
             jax.random.normal(ks[4], inp.src_hsqc.shape[:2]), jax.random.normal(ks[5], inp.src_cosy.shape))
    got = tstep.jitter_spectra_device(tb, None, 0.4, 2.5, 0.6,
                                      noise=[torch.from_numpy(np.asarray(d)) for d in draws])
    _assert_inputs_close(got, ref, 1e-6)


def test_warp_spectra_matches_jax():
    jb, tb = _transform_batches()
    key = jax.random.PRNGKey(9)
    ref = jstep.warp_spectra_device(jb, key, 0.5, 6.0, 0.7)
    ks = jax.random.split(key, 3)
    draws = (jax.random.uniform(ks[0], (6,)), jax.random.normal(ks[1], (6, 6)),
             jax.random.normal(ks[2], (6, 5)))
    got = tstep.warp_spectra_device(tb, None, 0.5, 6.0, 0.7,
                                    noise=[torch.from_numpy(np.asarray(d)) for d in draws])
    _assert_inputs_close(got, ref, 1e-6)
    assert not torch.equal(got.inputs.src_13c, tb.inputs.src_13c)


def test_scheduled_sampling_matches_jax():
    """Two-pass scheduled sampling (dropout off) with JAX's categorical and
    Bernoulli draws injected as their Gumbel and uniform noise."""
    cfg = _cfg(ss_prob=0.6, ss_ramp_steps=100)
    params = jmmt.init_params(cfg.model, jax.random.PRNGKey(1))
    jmodel, tmodel = _models(cfg, params)
    jb, tb = _batches(cfg.model)
    rng, step = jax.random.PRNGKey(3), 50
    jtotal, _ = jstep.loss_fn(params, jmodel, cfg, jb, rng, jnp.asarray(step))
    _, r_samp, r_mix, _ = jax.random.split(rng, 4)
    B, T, V = jb.trg_tokens.shape[0], jb.trg_tokens.shape[1] - 1, cfg.model.smiles_vocab_size
    gumbel = jax.random.gumbel(r_samp, (B, T, V))
    uniform = jax.random.uniform(r_mix, (B, T))
    # the draws are JAX's own: categorical is argmax(logits + gumbel), bernoulli is uniform < p
    probe = jax.random.normal(jax.random.PRNGKey(0), (B, T, V))
    assert bool((jax.random.categorical(r_samp, probe) == jnp.argmax(probe + gumbel, -1)).all())
    assert bool((jax.random.bernoulli(r_mix, 0.3, (B, T)) == (uniform < 0.3)).all())
    tmodel.train()
    ttotal, _ = tstep.loss_fn(tmodel, _torch_cfg(cfg), tb, None, step,
                              noise=(torch.from_numpy(np.asarray(gumbel)),
                                     torch.from_numpy(np.asarray(uniform))))
    _assert_close_rel(ttotal.detach(), jtotal, 1e-5, "ss total")
    plain, _ = tstep.loss_fn(tmodel, _torch_cfg(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, ss_prob=0.0))), tb)
    assert float(plain) != float(ttotal)  # the mixed inputs changed the loss


# ---------------------------------------------------------------------------
# dropout, remat and init
# ---------------------------------------------------------------------------

def test_dropout_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400_000)
    y = tlayers.dropout(x, 0.1, gen)
    kept = (y != 0).float().mean().item()
    sd = (0.9 * 0.1 / x.numel()) ** 0.5
    assert abs(kept - 0.9) < 5 * sd
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1.0 / torch.tensor(0.9).item()]))
    yb = tlayers.dropout(x.bfloat16(), 0.1, gen)
    assert yb.dtype == torch.bfloat16
    assert set(torch.unique(yb.float()).tolist()) == {0.0, float(torch.tensor(1.0).bfloat16()
                                                                  / torch.tensor(0.9).bfloat16())}
    assert tlayers.dropout(x, 0.1, None) is x


def test_dropout_same_seed_and_step_same_step():
    """The step's dropout comes from (seed, step): the same pair gives the
    same loss and gradients, another step or seed another loss; eval mode
    and a model without a generator are deterministic."""
    cfg = _torch_cfg(_cfg(dropout=0.1))
    model = tmmt.init_model(cfg.model, 0, "cpu").train()
    _, tb = _batches(ModelConfig(**SMALL))

    def loss_and_grad(seed, step):
        model.zero_grad(set_to_none=True)
        total, _ = tstep.loss_fn(model, cfg, tb, tstep.step_generator(seed, step), step)
        total.backward()
        return float(total), model.fp1.weight.grad.clone()

    a, ga = loss_and_grad(0, 7)
    b, gb = loss_and_grad(0, 7)
    assert a == b and torch.equal(ga, gb)
    assert loss_and_grad(0, 8)[0] != a and loss_and_grad(1, 7)[0] != a
    with torch.no_grad():
        det = float(tstep.loss_fn(model, cfg, tb)[0])
        model.eval()
        ev = float(tstep.loss_fn(model, cfg, tb, tstep.step_generator(0, 7))[0])
    assert det == ev != a


def test_remat_same_loss_and_grads():
    cfg = _torch_cfg(_cfg(dropout=0.1))
    cfg_r = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    _, tb = _batches(ModelConfig(**SMALL))
    out = []
    for c in (cfg, cfg_r):
        model = tmmt.init_model(c.model, 0, "cpu").train()
        total, _ = tstep.loss_fn(model, c, tb, tstep.step_generator(0, 3), 3)
        total.backward()
        out.append((float(total), _grads(model)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for name, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][name], g, rtol=1e-5, atol=1e-7, err_msg=name)


def test_init_follows_jax_initializers():
    """Each leaf's spread against the JAX package's init: zero biases and
    unit LayerNorm scales exactly, standard deviations within 15%."""
    cfg = ModelConfig(**SMALL)
    ref = tconvert.from_jax_params(jmmt.init_params(cfg, jax.random.PRNGKey(0)))
    model = tmmt.init_model(_torch_cfg(MMTConfig(model=cfg)).model, 0, "cpu")
    again = tmmt.init_model(_torch_cfg(MMTConfig(model=cfg)).model, 0, "cpu")
    for name, p in model.state_dict().items():
        r = ref[name]
        assert torch.equal(p, again.state_dict()[name]), name
        if r.std() == 0:
            assert torch.equal(p, r), name
        elif r.numel() >= 256:
            assert p.std().item() == pytest.approx(r.std().item(), rel=0.15), name
            assert p.abs().max() <= 2.2 * r.abs().max(), name
