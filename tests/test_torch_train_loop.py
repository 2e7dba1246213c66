"""The port's checkpoints, parameter export, training loop and ``cli train``.

Checkpoint resume is exact (dropout on); a ``params.msgpack`` the port writes
loads in the JAX package's ``import_params_msgpack`` (float32, and bf16
gzipped) and is byte for byte what flax writes for the same tree; the
JAX-written phase3 checkpoint starts the port's trainer; ``cli train``
prints the JAX command's keys."""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multimodalspectraltransformer_torch import cli as tcli
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.train import checkpoint as tckpt
from multimodalspectraltransformer_torch.train import loop as tloop
from multimodalspectraltransformer_torch.train import state as tstate
from multimodalspectraltransformer_torch.train import step as tstep
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu import cli as jcli
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.train import checkpoint as jckpt
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
SMALL = dict(hidden_size=32, num_heads=4, cross_num_heads=4, num_encoder_layers=2,
             num_decoder_layers=2, ffn_dim=64)
MCFG = tconfig.ModelConfig(**SMALL)
CFG = tconfig.MMTConfig(model=MCFG, train=tconfig.TrainConfig(
    learning_rate=1e-3, num_epochs=3, save_interval_steps=1, weight_fp=0.1))


def _batch(n: int = 4, seed: int = 0) -> tdp.TrainBatch:
    recs = tdp.synthetic_dataset(n, seed=seed)
    b = tdp.collate([tdp.featurize(r, MCFG) for r in recs])
    return tdp.to_device(tdp.TrainBatch(tmmt.MMTBatch(*b.inputs), b.trg_tokens, b.trg_fp), "cpu")


def _state(seed: int = 0) -> tstate.TrainState:
    return tstate.create_state(CFG.train, tmmt.init_model(MCFG, seed, "cpu"))


def test_checkpoint_resume_exact(tmp_path):
    """Save at step 3, restore into a fresh state, two more steps: equal to
    two uninterrupted steps, with dropout on (its masks come from (seed,
    step))."""
    b = _batch()
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    state = _state()
    for _ in range(3):
        state, _ = tstep.train_step(CFG, state, b, seed=1)
    assert mgr.save(state, metrics={"loss": 1.0}) and mgr.latest_step() == 3
    for _ in range(2):
        state, m_live = tstep.train_step(CFG, state, b, seed=1)

    restored = mgr.restore(_state(seed=9))
    assert restored is not None and restored.step == 3
    for _ in range(2):
        restored, m_rest = tstep.train_step(CFG, restored, b, seed=1)
    assert float(m_live.loss) == float(m_rest.loss)
    for (name, a), c in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, c), name
    mgr.close()


def test_checkpoint_manager_interval_keep_and_atomic_files(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2, save_interval_steps=2)
    state = _state()
    assert mgr.latest_step() is None and mgr.restore(_state()) is None
    saved = []
    for step in range(1, 8):
        state.step = step
        saved.append(mgr.save(state))
    assert saved == [False, True, False, True, False, True, False]
    assert sorted(os.listdir(tmp_path)) == ["4.pt", "6.pt"]  # keep 2, no temporary left
    assert not mgr.should_save(6) and mgr.should_save(8)
    assert mgr.restore(_state(), step=4).step == 4


def test_exported_msgpack_loads_in_jax(tmp_path):
    """float32 and bf16-gzipped exports through the JAX package's
    ``import_params_msgpack``; the float32 bytes are flax's own."""
    jcfg = ModelConfig(**SMALL)
    template = jmmt.init_params(jcfg, jax.random.PRNGKey(0))
    model = tmmt.init_model(MCFG, 3, "cpu")
    sd = model.state_dict()
    p32 = str(tmp_path / "params.msgpack")
    tckpt.export_params_msgpack(model, p32)
    loaded = tconvert.from_jax_params(jckpt.import_params_msgpack(template, p32))
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k
    with open(p32, "rb") as f:
        assert f.read() == serialization.to_bytes(tconvert.to_jax_params(sd))
    pbf = str(tmp_path / "params.msgpack.gz")
    tckpt.export_params_msgpack(sd, pbf, dtype=torch.bfloat16)
    loaded = tconvert.from_jax_params(jckpt.import_params_msgpack(template, pbf))
    back = tckpt.import_params_msgpack(pbf)
    for k, v in sd.items():
        want = v.to(torch.bfloat16).float()
        assert torch.equal(loaded[k], want) and torch.equal(back[k], want), k


def test_phase3_starts_the_port_trainer(tmp_path):
    """The JAX-written phase3 file loads into the full-width trainer, which
    takes a step from it through ``run_training``."""
    cfg = tconfig.MMTConfig(train=tconfig.TrainConfig(learning_rate=3e-5, num_epochs=1))
    recs = tdp.synthetic_dataset(2, seed=4)
    loader = tdp.Loader(recs, cfg.model, batch_size=2)
    init = tckpt.import_params_msgpack(PHASE3)
    res = tloop.run_training(cfg, loader, init_params=init, max_steps=1, device="cpu")
    assert res.steps == 1 and np.isfinite(res.train_loss) and res.train_loss < 3.0
    moved = [k for k, v in res.state.model.state_dict().items() if not torch.equal(v, init[k])]
    assert len(moved) > 100


@pytest.mark.parametrize("path", ["device", "host", "transforms"])
def test_run_training_paths(tmp_path, path):
    """The device-dataset path, the host path and the batch transforms: every
    step logged with a finite loss, the plateau stepped per epoch, validation
    each epoch, checkpoints written; a second call resumes from them."""
    t = dict(learning_rate=1e-3, num_epochs=3, save_interval_steps=2, plateau_patience=0)
    if path == "transforms":
        t.update(warp_1h_ppm=0.3, warp_13c_ppm=4.0, jitter_1h_ppm=0.2, jitter_13c_ppm=3.0,
                 blank_percentage=0.3, ss_prob=0.5, ss_ramp_steps=4)
    cfg = tconfig.MMTConfig(model=MCFG, train=tconfig.TrainConfig(**t))
    recs = tdp.synthetic_dataset(10, seed=2)
    loader = tdp.Loader(recs, MCFG, batch_size=4, seed=1)
    val = tdp.Loader(tdp.synthetic_dataset(3, seed=9), MCFG, batch_size=3, drop_remainder=False)
    kw = dict(val_loader=val, metrics_path=str(tmp_path / "m.jsonl"),
              checkpoint_dir=str(tmp_path / "ckpt"), seed=0, device="cpu",
              device_data=path != "host")
    res = tloop.run_training(cfg, loader, **kw)
    assert res.steps == 6 and res.state.step == 6
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    train = [x for x in lines if "train_loss" in x]
    assert [x["step"] for x in train] == list(range(1, 7))
    assert all(np.isfinite(x["train_loss"]) and x["grad_norm"] > 0 for x in train)
    assert len([x for x in lines if "val_loss" in x]) == 3 and np.isfinite(res.val_loss)
    assert res.state.plateau.bad_count >= 0 and np.isfinite(res.state.plateau.best)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "4.pt", "6.pt"]
    more = tloop.run_training(cfg, loader, max_steps=8, **kw)
    assert more.steps == 8


def test_device_and_host_paths_train_alike():
    """The device dataset stores spectra as float16, so its batches differ
    from the host's in the last bits only: the two runs' losses agree within
    1e-3 relative."""
    cfg = tconfig.MMTConfig(model=MCFG, train=tconfig.TrainConfig(learning_rate=1e-3,
                                                                 num_epochs=2))
    recs = tdp.synthetic_dataset(8, seed=6)
    losses = []
    for device_data in (True, False):
        res = tloop.run_training(cfg, tdp.Loader(recs, MCFG, batch_size=4, seed=2),
                                 device="cpu", device_data=device_data)
        losses.append([x["train_loss"] for x in res.metrics.history])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


def test_run_training_refuses_what_is_not_ported():
    """A mesh (data parallelism) is refused; in-training generation metrics
    are ported, and every ``gen_metrics_every`` steps a line of them is
    logged."""
    loader = tdp.Loader(tdp.synthetic_dataset(4), MCFG, batch_size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloop.run_training(CFG, loader, mesh=object(), device="cpu")
    res = tloop.run_training(CFG, loader, gen_metrics_every=1, max_steps=2, device="cpu")
    gm = [x for x in res.metrics.history if "gen_validity" in x]
    assert [x["step"] for x in gm] == [1, 2]


def test_crash_backup(tmp_path):
    """A failing epoch leaves a parameter backup that the JAX package reads."""

    class Failing(tdp.Loader):
        def epoch(self, epoch):
            yield from super().epoch(epoch)
            raise RuntimeError("disk gone")

    loader = Failing(tdp.synthetic_dataset(4), MCFG, batch_size=2)
    with pytest.raises(RuntimeError, match="disk gone"):
        tloop.run_training(CFG, loader, checkpoint_dir=str(tmp_path), device="cpu",
                           device_data=False)
    backup = str(tmp_path / "last_backup_params.msgpack")
    template = jmmt.init_params(ModelConfig(**SMALL), jax.random.PRNGKey(0))
    jckpt.import_params_msgpack(template, backup)
    assert set(tckpt.import_params_msgpack(backup)) == set(tmmt.init_model(MCFG, 0, "cpu")
                                                           .state_dict())


def test_prefetch_forwards_errors_and_stops_when_abandoned():
    def bad():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(tloop._prefetch(bad(), lambda x: x))
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    n_threads = threading.active_count()
    gen = tloop._prefetch(endless(), lambda x: x * 2, depth=2)
    assert [next(gen) for _ in range(3)] == [0, 2, 4]
    gen.close()
    deadline = time.time() + 5
    while threading.active_count() > n_threads and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == n_threads
    assert len(produced) < 10


def test_metrics_logger_writes_jsonl(tmp_path):
    log = tloop.MetricsLogger(str(tmp_path / "m.jsonl"))
    log.log({"step": 1, "loss": torch.tensor(0.5), "tag": "x"})
    log.close()
    assert json.loads(open(tmp_path / "m.jsonl").read()) == {"step": 1.0, "loss": 0.5, "tag": "x"}
    assert log.history == [{"step": 1.0, "loss": 0.5, "tag": "x"}]


def _jax_cli_keys(monkeypatch, tmp_path) -> set:
    """The keys of the JAX ``cli train`` JSON line, from its own code, with
    training and export stubbed out."""
    from multimodalspectraltransformer_tpu.train import loop as jloop

    class Result:
        steps, train_loss, val_loss = 0, 0.0, 0.0
        state = types.SimpleNamespace(params=None)

    monkeypatch.setattr(jloop, "run_training", lambda *a, **k: Result())
    monkeypatch.setattr(jckpt, "export_params_msgpack", lambda *a, **k: None)
    monkeypatch.setattr(jcli, "_start_heartbeat", lambda tag: None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jcli.main(["train", "--synthetic", "8", "--out", str(tmp_path / "jax")])
    return set(json.loads(out.getvalue().strip().splitlines()[-1]))


def test_cli_train_prints_the_jax_commands_keys(monkeypatch, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["train", "--factory", "32", "--steps", "3", "--batch-size", "8",
                        "--device", "cpu", "--out", str(tmp_path / "run")])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) == _jax_cli_keys(monkeypatch, tmp_path)
    assert line["steps"] == 3 and np.isfinite(line["train_loss"]) and np.isfinite(line["val_loss"])
    template = jmmt.init_params(ModelConfig(), jax.random.PRNGKey(0))
    loaded = jckpt.import_params_msgpack(template, line["params"])
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(loaded))
    assert jnp.asarray(loaded["fc_out"]["kernel"]).shape == (128, 43)


# ---------------------------------------------------------------------------
# in-training generation metrics and the spectral feedback term
# ---------------------------------------------------------------------------

_GM: dict = {}


def _gen_metrics_setup():
    """phase3 in both packages (full width, float32) and one batch of 8
    factory molecules simulated by the port, featurized by each package."""
    if "setup" not in _GM:
        from multimodalspectraltransformer_torch.data import molrandom
        from multimodalspectraltransformer_torch.sim import factory as tfactory
        from multimodalspectraltransformer_tpu.data import pipeline as jdp

        recs = tfactory.simulate_records(molrandom.random_corpus(8, seed=31), device="cpu")
        jcfg = ModelConfig()
        jb = jdp.collate([jdp.featurize(r, jcfg) for r in recs])
        tb = tdp.to_device(tdp.collate([tdp.featurize(r, tconfig.ModelConfig()) for r in recs]),
                           "cpu")
        params = jckpt.import_params_msgpack(jmmt.init_params(jcfg, jax.random.PRNGKey(0)),
                                             PHASE3)
        _GM["setup"] = (params, tmmt.load_model(PHASE3, tconfig.ModelConfig(), device="cpu"),
                        jax.tree.map(jnp.asarray, jb), tb)
    return _GM["setup"]


@pytest.mark.parametrize("case", ["plain", "weighted"])
def test_generation_metrics_match_jax(case):
    """phase3's greedy generations on 8 factory molecules are the JAX
    package's, string for string, and every metric is within 1e-6 relative
    (NaN where JAX's is NaN): with the defaults, and with every auxiliary
    term live (MW, spectral feedback, tanimoto, validity; annealed weights,
    a fixed MW range)."""
    from multimodalspectraltransformer_tpu.train import loop as jloop
    from multimodalspectraltransformer_tpu.utils.config import MMTConfig, TrainConfig

    params, model, jb, tb = _gen_metrics_setup()
    train = {}
    if case == "weighted":
        train = dict(weight_mw=2.0, weight_sgnn=0.5, weight_tanimoto=0.3, weight_validity=0.7,
                     sgnn_feedback=True, change_loss_weights=True, batch_frequency=3,
                     train_weight_min=50.0, train_weight_max=600.0)
    jcfg = MMTConfig(model=ModelConfig(), train=TrainConfig(**train))
    tcfg = tconfig.MMTConfig(train=tconfig.TrainConfig(**train))
    ours = tloop.generation_metrics(model, tcfg, tb, step=7)
    theirs = jloop.generation_metrics(jmmt.MultimodalTransformer(jcfg.model), jcfg, params, jb,
                                      step=7)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if np.isnan(v):
            assert np.isnan(ours[k]), k
        else:
            assert abs(ours[k] - v) <= 1e-6 * max(abs(v), 1e-12), (k, ours[k], v)
    if case == "weighted":
        assert theirs["gen_validity"] > 0.5 and np.isfinite(theirs["sgnn_sim_error"])
        assert theirs["weight_MW"] > 2.0  # annealed
    gen, _ = tloop.greedy_generations(model, tcfg, tb)
    from multimodalspectraltransformer_tpu.decode import samplers as jsamplers
    from multimodalspectraltransformer_tpu.eval.harness import _encode_batch
    from multimodalspectraltransformer_tpu.utils import vocab as jvocab

    enc = _encode_batch(jmmt.MultimodalTransformer(jcfg.model), params, jb.inputs)
    res = jsamplers.greedy_decode(params, jcfg.model, enc.memory, enc.memory_key_padding_mask,
                                  1.0, jcfg.model.spectrum_points)
    assert gen == jvocab.batch_ids_to_smiles(np.asarray(res.tokens))


def test_spectral_feedback_error_matches_jax():
    """The feedback term on the same generations (the batch's own targets,
    one invalid string, one molecule without HSQC input) equals JAX's within
    1e-6 relative; none valid gives NaN."""
    from multimodalspectraltransformer_tpu.train import loop as jloop

    _, _, jb, tb = _gen_metrics_setup()
    from multimodalspectraltransformer_torch.utils import vocab as tvocab

    gen = [tvocab.ids_to_smiles(t[1:]) for t in tb.trg_tokens.numpy()]
    gen[2] = "C1CC("
    valid = np.array([g != "C1CC(" for g in gen])
    tb_blank = tb._replace(inputs=tb.inputs._replace(src_hsqc=tb.inputs.src_hsqc.clone()))
    tb_blank.inputs.src_hsqc[5] = 0.0
    jb_blank = jb._replace(inputs=jb.inputs._replace(
        src_hsqc=jnp.asarray(tb_blank.inputs.src_hsqc.numpy())))
    ours = tloop.spectral_feedback_error(gen, tb_blank, valid)
    theirs = jloop.spectral_feedback_error(gen, jb_blank, valid)
    assert np.isfinite(theirs) and abs(ours - theirs) <= 1e-6 * abs(theirs), (ours, theirs)
    assert np.isnan(tloop.spectral_feedback_error(gen, tb, np.zeros(len(gen), bool)))
