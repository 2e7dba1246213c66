"""The port's roofline scripts against the JAX package's on the CPU.

``scripts/torch_roofline.py`` holds ``scripts/roofline.py``'s analytic
counts: every FLOP and byte count equal, exactly, at the same measured
times; the shares differ only by the ratio of the two chips' peaks (within
1e-12 relative, float rounding). ``scripts/torch_roofline_report.py``
counts a train step with ``FlopCounterMode``: at ``ModelConfig.small()``
that count is 1.000164 times the analytic 3 x forward count of
``torch_roofline.forward_flops_per_sample`` (the backward counted as twice
the forward's matrix products; the rest is the fingerprint head's
backward), held within 1e-3. Its HBM model is the JAX script's, with the
parameter count of the JAX model.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch.utils import roofline as troofline
from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig
from multimodalspectraltransformer_tpu.utils.config import ModelConfig as JModelConfig
from torch_test_support import REPO, load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(script: str, args: list[str]) -> dict:
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), *args, "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


COUNTS = {"model_params": (), "train_step": ("batch", "ms", "flops", "achieved_flops_per_s",
                                             "hbm_bytes_modeled", "hbm_gbps_modeled"),
          "mns_decode_round": ("lanes", "ms", "flops", "achieved_flops_per_s", "hbm_gbps_modeled")}


@pytest.mark.parametrize("args", [
    ["--train-ms", "158", "--decode-ms", "265"],
    ["--train-ms", "190.123", "--decode-ms", "411.5", "--train-batch", "32", "--decode-lanes",
     "6144", "--decode-mols", "48", "--decode-len", "64"],
])
def test_analytic_rows_equal_roofline_py(args):
    jax_rows = _json("roofline.py", args)
    ours = _json("torch_roofline.py", args)
    assert set(ours) == set(jax_rows)
    assert ours["model_params"] == jax_rows["model_params"]
    for row, keys in COUNTS.items():
        if not keys:
            continue
        assert set(ours[row]) == set(jax_rows[row]), row
        for k in keys:
            assert ours[row][k] == jax_rows[row][k], (row, k)
    jroof = load("scripts/roofline.py")
    ratio = jroof.V5E_BF16_PEAK / troofline.H100_PEAK_FLOPS["bfloat16"]
    for row in ("train_step", "mns_decode_round"):
        np.testing.assert_allclose(ours[row]["mfu_vs_bf16_peak"],
                                   jax_rows[row]["mfu_vs_bf16_peak"] * ratio, rtol=1e-12)
        assert "MXU" not in ours[row]["bound"] and "H100" in ours[row]["bound"]
    np.testing.assert_allclose(
        ours["mns_decode_round"]["hbm_util_modeled"],
        jax_rows["mns_decode_round"]["hbm_util_modeled"] * jroof.V5E_HBM_BW
        / troofline.H100_HBM_BYTES_PER_S, rtol=1e-12)


def test_analytic_functions_equal_roofline_py():
    jroof = load("scripts/roofline.py")
    ours = load("scripts/torch_roofline.py")
    for jcfg, cfg in ((JModelConfig(), ModelConfig()), (JModelConfig.small(), ModelConfig.small())):
        assert ours.model_shapes(cfg) == jroof.model_shapes(jcfg)
        assert ours.param_count(cfg) == jroof.param_count(jcfg)
        assert ours.forward_flops_per_sample(cfg) == jroof.forward_flops_per_sample(jcfg)
        assert ours.forward_flops_per_sample(cfg, 17) == jroof.forward_flops_per_sample(jcfg, 17)
        for t in (0, 31, 127):
            assert (ours.decode_step_flops_per_lane(cfg, t, 582)
                    == jroof.decode_step_flops_per_lane(jcfg, t, 582))
    for S, d, f in ((129, 128, 512), (66, 64, 256)):
        assert ours.encoder_layer_flops(S, d, f) == jroof.encoder_layer_flops(S, d, f)
        for cross in (True, False):
            assert (ours.decoder_layer_flops(63, S, d, f, cross)
                    == jroof.decoder_layer_flops(63, S, d, f, cross))


def test_roofline_times_are_required():
    """No default time: JAX's 158 / 265 ms are TPU measurements."""
    ours = load("scripts/torch_roofline.py")
    for argv in ([], ["--train-ms", "100"], ["--decode-ms", "100"]):
        with pytest.raises(SystemExit) as e:
            ours.main(argv)
        assert e.value.code == 2


def test_report_train_flops_against_analytic_count():
    """FlopCounterMode over one bf16 train step at ModelConfig.small(), batch
    2, against 3 x the analytic forward count: ratio 1.000164, within 1e-3;
    the report's analytic fallback is the JAX script's formula."""
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import state as st

    report = load("scripts/torch_roofline_report.py")
    analytic = load("scripts/torch_roofline.py")
    cfg = ModelConfig.small()
    mcfg = MMTConfig(model=cfg, train=TrainConfig(mixed_precision=True))
    model = mmt.init_model(cfg, 0, "cpu")
    state = st.create_state(mcfg.train, model)
    batch = report.train_batch(cfg, 2, torch.device("cpu"))
    flops, src = report.train_flops(mcfg, state, batch)
    assert src == "flop_counter_mode"
    ratio = flops / (3 * analytic.forward_flops_per_sample(cfg) * 2)
    assert abs(ratio - 1) < 1e-3, ratio
    sd = model.state_dict()
    dense = 2.0 * sum(v.numel() for v in sd.values() if v.dim() >= 2)
    tokens = 2 * (5 * cfg.nmr_seq_len + 63)
    assert report.analytic_train_flops(sd, cfg, 2) == 3.0 * dense * tokens / 5


def test_report_hbm_model_equals_jax_script():
    """The train step's modeled bytes: the JAX script's P * (2 * 3 + 4 * 3) +
    B * heads * 902^2 * 4, with P the JAX model's parameter count."""
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_tpu.models import mmt as jmmt

    report = load("scripts/torch_roofline_report.py")
    jcfg, cfg = JModelConfig.small(), ModelConfig.small()
    P = sum(int(np.prod(np.shape(x))) for x in jax.tree_util.tree_leaves(
        jmmt.init_params(jcfg, jax.random.PRNGKey(0))))
    B = 64
    ref = P * (2 * 3 + 4 * 3) + B * jcfg.num_heads * 902 * 902 * 2 * 2
    assert report.train_hbm_bytes(mmt.init_model(cfg, 0, "cpu"), cfg, B) == ref


def test_report_on_cpu_when_asked(monkeypatch, capsys):
    """``main(device="cpu")`` at full width with one step and one molecule
    prints one JSON dict of both rows and their sentences (times of the CPU:
    no device figure)."""
    monkeypatch.setenv("ROOFLINE_BATCH", "2")
    monkeypatch.setenv("ROOFLINE_STEPS", "1")
    monkeypatch.setenv("ROOFLINE_MOLS", "1")
    report = load("scripts/torch_roofline_report.py")
    out = report.main([], device="cpu")
    assert json.loads(capsys.readouterr().out) == out
    assert out["card"] == "cpu (no card)"
    assert out["train_step"]["flops_source"] == "flop_counter_mode"
    assert out["train_step"]["name"] == "train_step B=2 bf16"
    assert out["mns_decode"]["name"] == "MNS fan-out decode 1x128 lanes, 64 tokens bf16"
    cost = troofline.decode_step_cost(ModelConfig(), mmt_state(), 128, 32.0, 582)
    assert out["mns_decode"]["flops"] == cost["flops"] * 64
    assert out["mns_decode"]["hbm_bytes"] == cost["hbm_bytes"] * 64
    assert len(out["sentences"]) == 2
    for row in ("train_step", "mns_decode"):
        assert out[row]["wall_s"] > 0 and out[row]["bound"] in ("compute", "HBM-bandwidth")


def mmt_state() -> dict:
    from multimodalspectraltransformer_torch.models import mmt

    return mmt.init_model(ModelConfig(), 0, "cpu").state_dict()
