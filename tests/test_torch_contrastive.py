"""The port's contrastive trainers and the CLIP tower's training surface
against the JAX package's ``train/contrastive.py`` and ``rank/clip.py``.

The same numpy inputs and variables go through both packages on the CPU.
Tolerances:

- a tower step (CLIP and BLIP, dropout off) from the same float32
  encodings: the loss within 1e-5 relative; each gradient leaf within 1e-4
  of its largest magnitude; after three steps, the parameters within 1e-6
  wherever the gradient was resolved at every step (``chip_smoke.py``'s
  ``resolved_gradient``). Elsewhere AdamW's first steps turn float32 rounding
  noise into moves of about lr with either sign (the attention key biases,
  whose exact gradient is zero): those stay within 3 lr;
- the same gradients through the port's AdamW and optax's ``adamw``: 1e-6
  everywhere;
- ``train_contrastive`` end to end, the frozen MMT encode in bfloat16 on both
  sides: each step's loss within 2e-3 relative (the bound the trainer's
  bfloat16 loss is held to in ``test_torch_train.py``). The encodes differ by
  bfloat16 roundings that XLA's fusions drop and eager torch keeps (PR 7's
  finding for the CLIP tower), and the towers then train on slightly
  different fingerprints and memories; measured 2.4e-4 (CLIP) and 2.6e-4
  (BLIP), recorded as the JUnit property ``max_rel_loss_gap``. Retrieval
  recalls are equal, on the JAX run's final variables;
- converted HuggingFace and reference state dicts: exactly equal;
  ``save_bundle``: byte for byte what the JAX package writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from multimodalspectraltransformer_torch import cli as tcli
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.rank import clip as tc
from multimodalspectraltransformer_torch.rank import qformer as tq
from multimodalspectraltransformer_torch.train import contrastive as tcon
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.rank import clip as jc
from multimodalspectraltransformer_tpu.rank import qformer as jq
from multimodalspectraltransformer_tpu.train import contrastive as jcon
from multimodalspectraltransformer_tpu.utils.config import MMTConfig, ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_MODEL = dict(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64)
CLIP_SMALL = dict(text_layers=1, text_heads=2, cb_embedding=32, text_hidden=32, text_ffn=64,
                  projection_dim=16, dropout=0.0)
Q_SMALL = dict(hidden=32, num_heads=2, ffn_dim=64, num_layers=2, num_queries=4, encoder_width=32,
               projection_dim=16, dropout=0.0)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _mmt():
    """(JAX config, JAX params, port config, port state dict) of a tiny MMT."""
    jcfg = MMTConfig(model=ModelConfig(**TINY_MODEL))
    params = jmmt.init_params(jcfg.model, jax.random.PRNGKey(0))
    tcfg = tconfig.MMTConfig(model=tconfig.ModelConfig(**TINY_MODEL))
    return jcfg, params, tcfg, tconvert.from_jax_params(params)


def _records(n: int, seed: int = 0):
    """The same synthetic records for both packages."""
    jrecs = jdp.synthetic_dataset(n, seed=seed)
    return jrecs, [tdp.SampleRecord(**dataclasses.asdict(r)) for r in jrecs]


def _jax_tower(tower: str, rng):
    """A JAX tower (dropout off) at the small width, its variables moved off
    init by seeded noise (sorted, as a jitted function returns them), and the
    port's tower holding the same variables."""
    B, S = 4, 10
    toks = jnp.asarray(rng.integers(4, 43, (B, 16)), jnp.int32)
    mask = jnp.ones((B, 16), jnp.int32)
    if tower == "clip":
        jm = jc.CLIPRanker(jc.CLIPConfig(**CLIP_SMALL))
        v = jm.init(jax.random.PRNGKey(1), toks, mask, jnp.zeros((B, 512)), True)
    else:
        jm = jq.BLIPRanker(jq.QFormerConfig(**Q_SMALL), jq_text_cfg())
        v = jm.init(jax.random.PRNGKey(1), toks, mask, jnp.zeros((B, S, 128)),
                    jnp.zeros((B, S), bool), True)
    v = jax.tree.map(lambda a: np.asarray(a + 0.05 * rng.normal(size=a.shape), np.float32), v)
    model, *_ = tcon.make_tower(tower, tc.CLIPConfig(**CLIP_SMALL) if tower == "clip"
                                else tq.QFormerConfig(**Q_SMALL))
    from_tree = tconvert.from_jax_clip_params if tower == "clip" else tconvert.from_jax_blip_params
    tcon._load_tower(model, tower, from_tree(v))
    return jm, v, model, from_tree


def jq_text_cfg():
    q = jq.QFormerConfig(**Q_SMALL)
    return jc.CLIPConfig(text_layers=2, text_heads=4, text_hidden=q.encoder_width,
                         text_ffn=4 * q.encoder_width, cb_embedding=q.encoder_width,
                         projection_dim=q.projection_dim, dropout=0.0)


def _encodings(rng, B: int = 4, S: int = 10):
    fp = rng.normal(size=(B, 512)).astype(np.float32)
    memory = rng.normal(size=(B, S, 128)).astype(np.float32)
    kpm = np.zeros((B, S), bool)
    kpm[1, 7:] = True
    toks = rng.integers(4, 43, (B, 16)).astype(np.int32)
    mask = np.ones((B, 16), np.int32)
    mask[2, 9:] = 0
    return fp, memory, kpm, toks, mask


# ---------------------------------------------------------------------------
# the tower step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower", ["clip", "blip"])
def test_tower_steps_match_jax_and_optax(tower):
    rng = np.random.default_rng(0)
    jm, v, model, from_tree = _jax_tower(tower, rng)
    lr = 1e-3
    ccfg = tcon.ContrastiveConfig(learning_rate=lr)
    tx = optax.adamw(lr, weight_decay=ccfg.weight_decay)
    params = v["params"]
    opt_state = tx.init(params)
    opt = tcon.make_optimizer(tcon.trained_parameters(model, tower), ccfg)

    def jloss(p, fp, memory, kpm, toks, mask):
        if tower == "clip":
            cb, mt = jm.apply({"params": p}, toks, mask, fp, False)
            return jc.clip_loss(cb, mt, 1.0).mean_loss
        text, spec = jm.apply({"params": p}, toks, mask, memory, kpm, False)
        return jq.blip_loss(text, spec, 1.0).mean_loss

    grad_fn = jax.jit(jax.value_and_grad(jloss))
    resolved = None
    for _ in range(3):
        fp, memory, kpm, toks, mask = _encodings(rng)
        jl, jg = grad_fn(params, *(jnp.asarray(x) for x in (fp, memory, kpm, toks, mask)))
        updates, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, updates)
        tl = tcon.tower_step(model, opt, tower, (_t(fp), _t(memory), _t(kpm)), _t(toks),
                             _t(mask), 1.0)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), (float(tl), float(jl))
        ref = from_tree({"params": jax.tree.map(np.asarray, jg)})
        got = {n: p.grad for n, p in model.named_parameters() if n in ref}
        assert set(got) == set(ref)
        ok = {}
        for name, g in ref.items():
            scale = max(float(g.abs().max()), 1e-12)
            np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
            ok[name] = chip_smoke.resolved_gradient(g, got[name])
        resolved = ok if resolved is None else {k: resolved[k] & ok[k] for k in ok}
    want = from_tree({"params": jax.tree.map(np.asarray, params)})
    sd = model.state_dict()
    for name, w in want.items():
        diff = (sd[name] - w).abs()
        r = resolved[name]
        if r.any():
            assert float(diff[r].max()) <= 1e-6, name
        assert float(diff.max()) <= 3 * lr, name


def test_adamw_matches_optax_on_the_same_gradients():
    """Three applications of the same seeded gradients (of mixed scales) to
    the CLIP tower: the port's optimizer and optax's ``adamw`` agree within
    1e-6 on every parameter."""
    rng = np.random.default_rng(1)
    _, v, model, from_tree = _jax_tower("clip", rng)
    ccfg = tcon.ContrastiveConfig(learning_rate=1e-2, weight_decay=0.05)
    tx = optax.adamw(ccfg.learning_rate, weight_decay=ccfg.weight_decay)
    params = v["params"]
    opt_state = tx.init(params)
    opt = tcon.make_optimizer(tcon.trained_parameters(model, "clip"), ccfg)
    for _ in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape)
                                        * 10.0 ** rng.integers(-4, 1)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = from_tree({"params": grads})
        for name, p in model.named_parameters():
            p.grad = tg[name].clone()
        opt.step()
    want = from_tree({"params": jax.tree.map(np.asarray, params)})
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# train_contrastive and retrieval_accuracy end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tower", ["clip", "blip"])
def test_train_contrastive_and_retrieval_match_jax(tower, record_property):
    jcfg, jparams, tcfg, tparams = _mmt()
    jrecs, trecs = _records(12)
    rng = np.random.default_rng(2)
    _, v, _, from_tree = _jax_tower(tower, rng)
    ccfg = dict(num_epochs=2, batch_size=6, learning_rate=3e-4)
    if tower == "clip":
        cfgs = (dict(tower_cfg=jc.CLIPConfig(**CLIP_SMALL)),
                dict(tower_cfg=tc.CLIPConfig(**CLIP_SMALL)))
    else:
        cfgs = (dict(tower_cfg=jq.QFormerConfig(**Q_SMALL), text_tower_cfg=jq_text_cfg()),
                dict(tower_cfg=tq.QFormerConfig(**Q_SMALL),
                     text_tower_cfg=tc.CLIPConfig(**dataclasses.asdict(jq_text_cfg()))))
    jv, jlog = jcon.train_contrastive(jcfg, jparams, jrecs, tower=tower,
                                      ccfg=jcon.ContrastiveConfig(**ccfg), init_variables=v,
                                      **cfgs[0])
    model, tlog = tcon.train_contrastive(tcfg, tparams, trecs, tower=tower,
                                         ccfg=tcon.ContrastiveConfig(**ccfg),
                                         init_variables=from_tree(v), device="cpu", **cfgs[1])
    key = f"{tower}_loss"
    jl = [r[key] for r in jlog.history if key in r]
    tl = [r[key] for r in tlog.history if key in r]
    assert len(jl) == len(tl) == 4
    gap = max(abs(a - b) / abs(b) for a, b in zip(tl, jl))
    record_property("max_rel_loss_gap", gap)
    assert gap <= 2e-3, (tl, jl)
    assert [r["step"] for r in tlog.history] == [r["step"] for r in jlog.history]

    # retrieval on the JAX run's final variables: equal recalls
    model.load_state_dict(from_tree(jax.tree.map(np.asarray, jv)), strict=tower == "clip")
    rj = jcon.retrieval_accuracy(jv, jcfg, jparams, jrecs, tower=tower, batch_size=6,
                                 **cfgs[0])
    rt = tcon.retrieval_accuracy(model, tcfg, tparams, trecs, tower=tower, batch_size=6,
                                 device="cpu")
    assert rt == rj


def test_contrastive_config_is_jax_s():
    assert dataclasses.asdict(tcon.ContrastiveConfig()) == dataclasses.asdict(
        jcon.ContrastiveConfig())


# ---------------------------------------------------------------------------
# snapshot, resume and the backup on failure (the JAX package's
# tests/test_contrastive.py on the port)
# ---------------------------------------------------------------------------

def _setup(n=12):
    _, _, tcfg, tparams = _mmt()
    return tcfg, _records(n)[1], tparams


TCLIP = tc.CLIPConfig(**dict(CLIP_SMALL, dropout=0.1))


def test_clip_training_decreases_loss(tmp_path):
    cfg, records, params = _setup()
    ccfg = tcon.ContrastiveConfig(num_epochs=6, batch_size=6, learning_rate=3e-4)
    model, logger = tcon.train_contrastive(cfg, params, records, tower="clip", ccfg=ccfg,
                                           tower_cfg=TCLIP, device="cpu",
                                           checkpoint_path=str(tmp_path / "clip.msgpack"))
    losses = [r["clip_loss"] for r in logger.history if "clip_loss" in r]
    assert len(losses) >= 6
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    back = tconvert.from_jax_clip_params(tconvert.read_msgpack(str(tmp_path / "clip.msgpack")))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    toks, mask = tcon.clip_tokenize(["CCO", "c1ccccc1"], 64)
    out = tc.score_candidates(model.eval(), TCLIP, _t(toks), _t(mask), torch.zeros(512))
    assert out.losses.shape == (2,) and torch.isfinite(out.losses).all()


def test_backup_checkpoint_on_failure(tmp_path, monkeypatch):
    cfg, records, params = _setup(8)

    class Boom(Exception):
        pass

    calls = {"n": 0}

    class ExplodingLogger(tcon.MetricsLogger):
        def log(self, metrics):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise Boom()
            return super().log(metrics)

    monkeypatch.setattr(tcon, "MetricsLogger", ExplodingLogger)
    with pytest.raises(Boom):
        tcon.train_contrastive(cfg, params, records, tower="clip",
                               ccfg=tcon.ContrastiveConfig(num_epochs=1, batch_size=4,
                                                           log_every=1),
                               tower_cfg=TCLIP, checkpoint_path=str(tmp_path / "c.msgpack"),
                               device="cpu")
    assert (tmp_path / "c.msgpack.backup.msgpack").exists()
    assert not (tmp_path / "c.msgpack").exists()


def test_snapshot_resume_continues_from_step(tmp_path):
    """A second call with a higher ``max_steps`` continues from the
    snapshot's step; the snapshot holds the tower and its optimizer as they
    were; resuming past the target trains no step but still exports."""
    cfg, records, params = _setup()
    ck = str(tmp_path / "clip.msgpack")
    model, _ = tcon.train_contrastive(
        cfg, params, records, tower="clip", tower_cfg=TCLIP, checkpoint_path=ck, device="cpu",
        ccfg=tcon.ContrastiveConfig(num_epochs=50, batch_size=6, max_steps=4, save_every=2,
                                    log_every=1))
    snap = torch.load(ck + ".state", weights_only=True)
    assert snap["step"] == 4
    for k, v in model.state_dict().items():
        assert torch.equal(snap["params"][k], v), k
    _, logger = tcon.train_contrastive(
        cfg, params, records, tower="clip", tower_cfg=TCLIP, checkpoint_path=ck, device="cpu",
        ccfg=tcon.ContrastiveConfig(num_epochs=50, batch_size=6, max_steps=7, save_every=2,
                                    log_every=1))
    assert [r["step"] for r in logger.history if "clip_loss" in r] == [5, 6, 7]
    os.remove(ck)
    _, logger3 = tcon.train_contrastive(
        cfg, params, records, tower="clip", tower_cfg=TCLIP, checkpoint_path=ck, device="cpu",
        ccfg=tcon.ContrastiveConfig(num_epochs=50, batch_size=6, max_steps=5, save_every=2))
    assert not [r for r in logger3.history if "clip_loss" in r]
    assert os.path.exists(ck)


def test_blip_training_smoke():
    cfg, records, params = _setup(8)
    qcfg = tq.QFormerConfig(**dict(Q_SMALL, dropout=0.1))
    model, logger = tcon.train_contrastive(
        cfg, params, records, tower="blip", tower_cfg=qcfg, device="cpu",
        ccfg=tcon.ContrastiveConfig(num_epochs=1, batch_size=4, max_steps=2))
    losses = [r["blip_loss"] for r in logger.history if "blip_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    untouched = tcon.make_tower("blip", qcfg)[0].state_dict()
    for name, p in model.state_dict().items():  # the ITM/LM-only leaves never move
        assert tq.is_contrastive_param(name) or torch.equal(p, untouched[name]), name


# ---------------------------------------------------------------------------
# the CLIP tower's training surface
# ---------------------------------------------------------------------------

def _roberta_state(L: int, d: int, ffn: int, vocab: int, n_pos: int, rng) -> dict:
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)
    sd = {"embeddings.word_embeddings.weight": r(vocab, d),
          "embeddings.position_embeddings.weight": r(n_pos, d),
          "embeddings.token_type_embeddings.weight": r(1, d),
          "embeddings.LayerNorm.weight": r(d), "embeddings.LayerNorm.bias": r(d),
          "pooler.dense.weight": r(d, d), "pooler.dense.bias": r(d)}
    for i in range(L):
        pre = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (ffn, d)), ("output.dense", (d, ffn))):
            sd[f"{pre}.{name}.weight"] = r(*shape)
            sd[f"{pre}.{name}.bias"] = r(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{pre}.{name}.weight"] = r(d)
            sd[f"{pre}.{name}.bias"] = r(d)
    return sd


def test_from_hf_roberta_and_from_torch_clip_equal_jax():
    """A synthetic RobertaModel and reference CLIPModel state dict (torch
    tensors for the latter): every converted array equals JAX's exactly, and
    the result loads into the port's tower."""
    cfg = dict(CLIP_SMALL, text_layers=2, text_max_len=30, text_vocab_size=50)
    rng = np.random.default_rng(4)
    roberta = _roberta_state(2, 32, 64, 50, 32, rng)
    ours = tc.from_hf_roberta(tc.CLIPConfig(**cfg), roberta)
    theirs = {}
    tconvert._roberta_sd(theirs, "te", jc.from_hf_roberta(jc.CLIPConfig(**cfg), roberta))
    assert {f"te.{k}" for k in ours} == set(theirs)
    for k, v in ours.items():
        assert torch.equal(v, theirs[f"te.{k}"]), k
    r = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ref = {f"CB_model.chemberta.{k}": torch.from_numpy(v) for k, v in roberta.items()}
    ref.update({"CB_model.LL1.weight": r(32, 32), "CB_model.LL1.bias": r(32)})
    for head, n_in in (("CB_projection", 32), ("MT_projection", 512)):
        ref.update({f"{head}.projection.weight": r(16, n_in), f"{head}.projection.bias": r(16),
                    f"{head}.fc.weight": r(16, 16), f"{head}.fc.bias": r(16),
                    f"{head}.layer_norm.weight": r(16), f"{head}.layer_norm.bias": r(16)})
    ours = tc.from_torch_clip(tc.CLIPConfig(**cfg), ref)
    theirs = tconvert.from_jax_clip_params(
        {"params": jc.from_torch_clip(jc.CLIPConfig(**cfg), ref)})
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k
    tc.CLIPRanker(tc.CLIPConfig(**cfg)).load_state_dict(ours)


def test_save_bundle_bytes_and_cross_loading(tmp_path):
    """The port's bundle is byte for byte the JAX package's for the same
    variables (the msgpack and the .json); each package's ``load_bundle``
    reads the other's."""
    cfg = dict(CLIP_SMALL, dropout=0.1)
    rng = np.random.default_rng(5)
    _, v, _, _ = _jax_tower("clip", rng)
    model = tc.CLIPRanker(tc.CLIPConfig(**cfg))
    model.load_state_dict(tconvert.from_jax_clip_params(v))
    pj, pt = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jc.save_bundle(pj, v, jc.CLIPConfig(**cfg))
    tc.save_bundle(pt, model, tc.CLIPConfig(**cfg))
    for suffix in ("", ".json"):
        with open(pj + suffix, "rb") as a, open(pt + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    jv, jcfg = jc.load_bundle(pt)
    assert jcfg == jc.CLIPConfig(**cfg)
    for k, w in tconvert.from_jax_clip_params(jax.tree.map(np.asarray, jv)).items():
        assert torch.equal(w, model.state_dict()[k]), k
    tm, tcfg = tc.load_bundle(pj, device="cpu")
    assert tcfg == tc.CLIPConfig(**cfg) and not tm.training
    for k, w in tm.state_dict().items():
        assert torch.equal(w, model.state_dict()[k]), k
    gz = str(tmp_path / "port.msgpack.gz")
    tc.save_bundle(gz, model, tc.CLIPConfig(**cfg))
    assert os.path.exists(str(tmp_path / "port.msgpack.json"))
    jv, _ = jc.load_bundle(gz)
    for k, w in tconvert.from_jax_clip_params(jax.tree.map(np.asarray, jv)).items():
        assert torch.equal(w, model.state_dict()[k]), k


def test_clip_dropout_repeats_and_only_in_training():
    """The same generator seed gives the same embeddings, another seed
    others; eval mode, or train mode without a generator, is the
    deterministic tower; dropout reaches the text encoder and both heads."""
    model = tcon.make_tower("clip", tc.CLIPConfig(**dict(CLIP_SMALL, dropout=0.1)))[0].train()
    fp, _, _, toks, mask = _encodings(np.random.default_rng(6))
    args = (_t(toks), _t(mask), _t(fp))
    gen = lambda s: torch.Generator().manual_seed(s)
    with torch.no_grad():
        a, b, c = (model(*args, generator=gen(s)) for s in (3, 3, 4))
        plain = model(*args)
        model.eval()
        ev = model(*args, generator=gen(3))
        model.train()
        pooled = [model.text_encoder(_t(toks), _t(mask), generator=gen(s)) for s in (3, 4)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y, z in zip(a, c, ev):
        assert not torch.equal(x, y) and not torch.equal(x, z)
    for x, y in zip(plain, ev):
        assert torch.equal(x, y)
    assert not torch.equal(*pooled)


# ---------------------------------------------------------------------------
# cli train-clip and train --gen-metrics-every
# ---------------------------------------------------------------------------

def _run_cli(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_train_clip(tmp_path):
    """``train-clip`` at the small MMT width on synthetic records: the JAX
    command's JSON keys, the tower and the bundle written (the bundle loads
    and scores), the run directory's step override obeyed."""
    out = tmp_path / "run"
    out.mkdir()
    (out / "clip_steps_override").write_text("2\n")
    res = _run_cli(["train-clip", "--synthetic", "12", "--small", "--steps", "5",
                    "--batch-size", "4", "--eval-n", "4", "--log-every", "1", "--device", "cpu",
                    "--out", str(out)])
    assert set(res) == {"steps", "final_loss", "retrieval"} and res["steps"] == 2
    assert np.isfinite(res["final_loss"])
    assert set(res["retrieval"]) == {"n", "text_to_spec_r1", "text_to_spec_r5",
                                     "spec_to_text_r1", "spec_to_text_r5"}
    assert res["retrieval"]["n"] == 4
    for name in ("clip.msgpack", "clip.msgpack.json", "metrics.jsonl"):
        assert (out / name).exists(), name
    model, cfg = tc.load_bundle(str(out / "clip.msgpack"), device="cpu")
    assert cfg == tc.CLIPConfig()
    toks, mask = tcon.clip_tokenize(["CCO", "CCN"], 64)
    out_scores = tc.score_candidates(model, cfg, _t(toks), _t(mask), torch.zeros(512))
    assert torch.isfinite(out_scores.losses).all()


def test_cli_train_gen_metrics_and_feature_cache(tmp_path, monkeypatch):
    """``train --gen-metrics-every 1`` logs the generation metrics each step;
    ``--feature-cache`` writes the featurized cache there and leaves the
    environment as it was."""
    monkeypatch.delenv("MMT_FEATURE_CACHE", raising=False)
    cache = tmp_path / "feat"
    res = _run_cli(["train", "--synthetic", "10", "--small", "--steps", "2", "--batch-size", "4",
                    "--gen-metrics-every", "1", "--feature-cache", str(cache), "--device", "cpu",
                    "--out", str(tmp_path / "run")])
    assert res["steps"] == 2
    lines = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    gm = [x for x in lines if "gen_validity" in x]
    assert [x["step"] for x in gm] == [1, 2]
    assert set(gm[0]) >= {"gen_validity", "gen_tanimoto_mean", "gen_exact", "MW_loss",
                          "sgnn_sim_error", "weight_MW", "weight_sgnn", "aux_loss_total"}
    assert len(list(cache.glob("mmt_features_*.npz"))) == 1
    assert "MMT_FEATURE_CACHE" not in os.environ


def test_factory_cache_round_trip(tmp_path):
    """``--factory-cache``: the first run simulates and writes the pickle,
    a second reads it back; another count refuses it."""
    cache = str(tmp_path / "recs.pkl")
    args = lambda n: tcli.build_parser().parse_args(
        ["evaluate", "--factory", str(n), "--factory-cache", cache, "--device", "cpu"])
    first = tcli._load_records(args(3), "cpu")
    again = tcli._load_records(args(3), "cpu")
    assert [r.smiles for r in first] == [r.smiles for r in again] and len(first) == 3
    assert again[0].hsqc == first[0].hsqc
    with pytest.raises(SystemExit, match="was generated with n=3"):
        tcli._load_records(args(4), "cpu")


def test_tower_on_the_contrastive_path_is_the_jax_init_tree():
    """``make_tower`` gives the JAX trainer's tree: the CLIP tower's every
    leaf, the BLIP tower's contrastive leaves, with the same shapes."""
    rng = np.random.default_rng(7)
    for tower in ("clip", "blip"):
        _, v, model, from_tree = _jax_tower(tower, rng)
        ref = from_tree(v)
        got = tcon.tower_state_dict(model, tower)
        assert set(got) == set(ref), tower
        assert all(got[k].shape == w.shape for k, w in ref.items()), tower
