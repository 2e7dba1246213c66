#!/usr/bin/env python3
"""Train a small MMT and run the full evaluation harness, on the card.

The port's counterpart of ``examples/02_train_and_evaluate.py``: synthetic
spectra -> training -> greedy and fan-out multinomial sampling -> filters ->
spectral-error ranking -> top-k metrics. ``max_steps`` caps the training
(60, the JAX example's, by default). Runs on the card unless
``main(device="cpu")``.

Run: python3 examples/torch_02_train_and_evaluate.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.data import pipeline as dp  # noqa: E402
from multimodalspectraltransformer_torch.eval import harness  # noqa: E402
from multimodalspectraltransformer_torch.train.loop import run_training  # noqa: E402
from multimodalspectraltransformer_torch.utils.config import (  # noqa: E402
    DecodeConfig, MMTConfig, ModelConfig, TrainConfig,
)
from multimodalspectraltransformer_torch.utils.device import resolve_device  # noqa: E402


def main(device=None, max_steps: int = 60):
    """Train and evaluate; returns (the training result, the eval summary)."""
    dev = resolve_device(device)
    mcfg = ModelConfig(num_encoder_layers=1, num_decoder_layers=2, ffn_dim=256)
    cfg = MMTConfig(model=mcfg, train=TrainConfig(learning_rate=1e-3, num_epochs=4))

    records = dp.synthetic_dataset(64, seed=0)
    train_recs, eval_recs = records[:48], records[48:56]

    loader = dp.Loader(train_recs, mcfg, batch_size=16)
    result = run_training(cfg, loader, max_steps=max_steps, device=dev)
    print(f"trained {result.steps} steps, loss {result.train_loss:.3f}")

    dcfg = DecodeConfig(max_len=32, fanout=16, multinom_runs=4, max_temp_rounds=3)
    results, summary = harness.evaluate_molecules(
        eval_recs, result.state.model, dcfg, simulate_errors=True, device=dev)
    print("greedy validity:", summary.greedy_validity)
    print("greedy exact:", summary.greedy_exact)
    print("MNS top-rank exact:", summary.mns_exact)
    print("mean best tanimoto:", summary.avg_best_tanimoto)
    return result, summary


if __name__ == "__main__":
    main()
