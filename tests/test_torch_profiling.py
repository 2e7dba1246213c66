"""The port's ``utils/profiling.py`` and ``utils/roofline.py`` against the
JAX package's: the phase timer's report and dictionary, a trace written on
the CPU, the roofline arithmetic with the H100's peaks, the decode-step cost
counted from the port's state dict, and a FLOP count."""

from __future__ import annotations

import json
import os
import time

import jax
import pytest
import torch

from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.utils import profiling as tprof
from multimodalspectraltransformer_torch.utils import roofline as troof
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.utils import profiling as jprof
from multimodalspectraltransformer_tpu.utils import roofline as jroof
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_timer_report_matches_jax():
    timers = (tprof.PhaseTimer(), jprof.PhaseTimer())
    for t in timers:
        for name, n in (("encode", 2), ("chemistry_filters", 1)):
            for _ in range(n):
                with t.phase(name):
                    time.sleep(0.002)
    ours, ref = timers
    assert set(ours.as_dict()) == set(ref.as_dict()) == {"encode", "chemistry_filters"}
    assert {k: v["calls"] for k, v in ours.as_dict().items()} == {"encode": 2,
                                                                  "chemistry_filters": 1}
    # the same table from the same spans
    ref.totals.update(ours.totals)
    assert ours.report() == ref.report()
    assert ours.report().splitlines()[0].split() == ["phase", "total_s", "calls", "mean_ms"]
    assert tprof.PhaseTimer().report() == jprof.PhaseTimer().report()


def test_phase_timer_records_a_span_that_raises():
    t = tprof.PhaseTimer()
    with pytest.raises(RuntimeError):
        with t.phase("fails"):
            raise RuntimeError("x")
    assert t.as_dict()["fails"]["calls"] == 1


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("matmul_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul_region" for e in events)
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.key == "matmul_region" for e in prof.key_averages())


def test_roofline_arithmetic_with_h100_peaks():
    r = troof.Roofline("x", wall_s=0.5, flops=989e12 * 0.25, hbm_bytes=3.35e12 * 0.1,
                       dtype="bfloat16")
    assert r.mfu == pytest.approx(0.5) and r.hbm_util == pytest.approx(0.2)
    assert r.bound == "compute"
    d = r.as_dict()
    assert d["mfu"] == 0.5 and d["hbm_utilization"] == 0.2 and d["bound"] == "compute"
    assert d["achieved_tflops"] == pytest.approx(494.5)
    m = troof.Roofline("y", wall_s=1.0, flops=67e12 * 0.01, hbm_bytes=3.35e12 * 0.3,
                       dtype="float32")
    assert m.bound == "HBM-bandwidth" and m.mfu == pytest.approx(0.01)
    assert "HBM-bandwidth-bound" in m.sentence() and "float32 peak" in m.sentence()
    # the same fields and formulas as the JAX package's, over other peaks
    j = jroof.Roofline("y", 1.0, 67e12 * 0.01, 3.35e12 * 0.3, "float32")
    assert set(m.as_dict()) == set(j.as_dict())
    assert m.achieved_flops == j.achieved_flops and m.achieved_bw == j.achieved_bw


@pytest.mark.parametrize("small", [True, False])
def test_decode_step_cost_matches_jax(small):
    cfg = ModelConfig.small() if small else ModelConfig()
    params = jmmt.init_params(cfg, jax.random.PRNGKey(0))
    sd = tconvert.from_jax_params(params)
    for lanes, t_avg, mem in ((1024, 31.5, 582), (8, 1.0, 64)):
        ours = troof.decode_step_cost(cfg, sd, lanes, t_avg, mem)
        ref = jroof.decode_step_cost(cfg, params, lanes, t_avg, mem)
        assert ours == pytest.approx(ref, rel=1e-12)
    assert troof._param_bytes(sd, "decoder.", 2) == jroof._param_bytes(params, "decoder", 2)


def test_flop_count_of_a_linear():
    lin = torch.nn.Linear(16, 32)
    x = torch.randn(4, 16)
    assert troof.flop_count(lin, x) == 2 * 4 * 16 * 32
    # forward and backward: the input and weight gradients double it again
    assert troof.flop_count(lambda: lin(x.requires_grad_()).sum().backward()) == 3 * 2 * 4 * 16 * 32
