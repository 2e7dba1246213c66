#!/usr/bin/env python3
"""Utilization report for the two headline device workloads on one NVIDIA
H100: the training step and the MNS fan-out decode. Prints one JSON dict
with each workload's ``Roofline.as_dict()`` (achieved TFLOP/s, share of the
bf16 peak, HBM GB/s and share, the bound resource), their ``sentence()``s,
and the card's name and power limit (nvidia-smi) beside them.

The counterpart of ``scripts/roofline_report.py``:

- the bf16 train step (``TrainConfig(mixed_precision=True)``) at the full
  width of ``ModelConfig()`` from the port's seeded initialisation, batch
  ``ROOFLINE_BATCH`` (64): a dummy batch with uniform 1H spectra and random
  targets of 64 tokens, through ``create_state`` / ``train_step``; one
  warm-up step, then ``ROOFLINE_STEPS`` (20) steps on the host clock, ended
  by reading the last loss. Its FLOPs are counted by ``FlopCounterMode``
  (``utils/roofline.flop_count``: matrix products forward and backward; the
  optimizer's elementwise work is not counted) over one more step, where the
  JAX script asks XLA's cost model; ``flops_source`` says which, and the
  analytic count from the parameter shapes stands in when the counter sees
  none. HBM traffic is modeled as the JAX script models it: bf16 weights
  read forward and backward and written, fp32 master weights and the two
  optimizer moments, and the attention probabilities of a 902-long fused
  sequence forward and backward in bf16;
- the MNS fan-out decode: ``ROOFLINE_MOLS`` (48) molecules x 128 lanes, 64
  tokens, ``multinomial_decode`` at temperature 1.0 in bf16 over the memory
  of the dummy batch; one warm-up call, then the mean of 3 calls, each ended
  by the tokens reaching the host. It runs without early exit, so the 64
  steps that ``decode_step_cost`` charges all run (K1 launches 64 x 6 a
  call, which the report checks).

Needs a CUDA device (``main(device="cpu")`` runs the same on the CPU, whose
times are no device figure):

    python3 scripts/torch_roofline_report.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

S_FUSED = 902  # the JAX script's fused-sequence length of its activation model


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_batch(cfg, batch_size: int, dev, seed: int = 1):
    """The JAX script's batch: ``dummy_batch`` with uniform [0, 1) 1H
    spectra, targets of 64 random tokens, zero fingerprints."""
    import numpy as np
    import torch

    from multimodalspectraltransformer_torch.data.pipeline import TrainBatch
    from multimodalspectraltransformer_torch.models import mmt

    rng = np.random.default_rng(seed)
    inputs = mmt.dummy_batch(cfg, batch_size, dev)
    inputs = inputs._replace(src_1h=torch.from_numpy(
        rng.random(tuple(inputs.src_1h.shape), dtype=np.float32)).to(dev))
    trg = torch.from_numpy(rng.integers(0, cfg.smiles_vocab_size, (batch_size, 64),
                                        dtype=np.int32)).to(dev)
    fp = torch.zeros(batch_size, cfg.fingerprint_size, device=dev)
    return TrainBatch(inputs, trg, fp)


def analytic_train_flops(sd, cfg, batch_size: int) -> float:
    """The JAX script's fallback: 3x forward matmul multiply-adds (forward +
    2x backward) per token or point processed; the encoder sees 5 lanes of
    ``nmr_seq_len`` points, the decoder 63 tokens."""
    from multimodalspectraltransformer_torch.utils import roofline

    dense = roofline._param_matmul_flops_per_token(sd, "")
    tokens = batch_size * (5 * cfg.nmr_seq_len + 63)
    return 3.0 * dense * tokens / 5  # rough split across subtrees


def train_flops(mcfg, state, batch) -> tuple[float, str]:
    """FLOPs of one train step and their source: ``FlopCounterMode`` over
    one step (which runs), else the analytic count."""
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.roofline import flop_count

    flops = flop_count(step.train_step, mcfg, state, batch, 2)
    if flops > 0:
        return flops, "flop_counter_mode"
    sd = state.model.state_dict()
    return analytic_train_flops(sd, mcfg.model, batch.trg_tokens.shape[0]), "analytic"


def train_hbm_bytes(model, cfg, batch_size: int) -> float:
    """bf16 weights read forward and backward and written, fp32 master
    weights and the two moments read and written, plus the attention
    probabilities of the fused sequence forward and backward in bf16."""
    n_params = sum(p.numel() for p in model.parameters())
    act = batch_size * cfg.num_heads * S_FUSED * S_FUSED * 2 * 2
    return float(n_params * (2 * 3 + 4 * 3) + act)


def train_roofline(dev, batch_size: int = 64, steps: int = 20, cfg=None) -> tuple:
    """The bf16 train step's ``Roofline`` and the row's other fields (see the
    module docstring)."""
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig
    from multimodalspectraltransformer_torch.utils.roofline import Roofline

    mcfg = MMTConfig(model=cfg or ModelConfig(), train=TrainConfig(mixed_precision=True))
    model = mmt.init_model(mcfg.model, 0, dev)
    state = st.create_state(mcfg.train, model)
    batch = train_batch(mcfg.model, batch_size, dev)
    state, m = step.train_step(mcfg, state, batch, 2)  # warm-up
    float(m.loss)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step.train_step(mcfg, state, batch, 2)
    float(m.loss)  # waits for the chain of steps
    step_s = (time.perf_counter() - t0) / steps
    flops, src = train_flops(mcfg, state, batch)
    r = Roofline(f"train_step B={batch_size} bf16", step_s, flops,
                 train_hbm_bytes(model, mcfg.model, batch_size), "bfloat16")
    return r, {"flops_source": src, "flops": r.flops, "hbm_bytes": r.hbm_bytes}


def decode_roofline(dev, n_mols: int = 48, fanout: int = 128, max_len: int = 64, reps: int = 3,
                    cfg=None) -> tuple:
    """The MNS fan-out decode's ``Roofline`` and the row's other fields (see
    the module docstring)."""
    import torch

    from multimodalspectraltransformer_torch.decode import samplers
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import decode_attention
    from multimodalspectraltransformer_torch.utils import roofline
    from multimodalspectraltransformer_torch.utils.config import ModelConfig

    cfg = cfg or ModelConfig()
    model = mmt.init_model(cfg, 0, dev).eval()
    params = model.state_dict()
    enc = model.encode(mmt.dummy_batch(cfg, n_mols, dev))
    lane_temp = torch.full((n_mols * fanout, 1), 1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def decode():
        res = samplers.multinomial_decode(
            params, cfg, enc.memory, enc.memory_key_padding_mask, gen, lane_temp, max_len,
            fanout=fanout, early_exit=False, compute_dtype="bfloat16", device=dev)
        return res.tokens.cpu()

    decode()  # warm-up
    decode_attention.reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        decode()
    dec_s = (time.perf_counter() - t0) / reps
    launches = decode_attention.launches
    if dev.type == "cuda" and launches != reps * max_len * cfg.num_decoder_layers:
        raise AssertionError(f"K1 launched {launches} times in {reps} decodes of {max_len} steps "
                             f"and {cfg.num_decoder_layers} layers")
    cost = roofline.decode_step_cost(cfg, params, lanes=n_mols * fanout, t_avg=max_len / 2,
                                     memory_s=enc.memory.shape[1])
    r = roofline.Roofline(f"MNS fan-out decode {n_mols}x{fanout} lanes, {max_len} tokens bf16",
                          dec_s, cost["flops"] * max_len, cost["hbm_bytes"] * max_len, "bfloat16")
    return r, {"flops": r.flops, "hbm_bytes": r.hbm_bytes, "k1_launches": launches}


def main(argv=None, device=None) -> dict:
    from multimodalspectraltransformer_torch.utils.device import card_line, resolve_device

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    dev = resolve_device(device)
    out = {"card": card_line(dev), "device": str(dev)}
    train = train_roofline(dev, int(os.environ.get("ROOFLINE_BATCH", "64")),
                           int(os.environ.get("ROOFLINE_STEPS", "20")))
    dec = decode_roofline(dev, int(os.environ.get("ROOFLINE_MOLS", "48")))
    for key, (r, extra) in (("train_step", train), ("mns_decode", dec)):
        out[key] = {**r.as_dict(), **extra}
    out["sentences"] = [train[0].sentence(), dec[0].sentence()]
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
