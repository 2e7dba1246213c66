#!/usr/bin/env python3
"""Self-improvement fine-tuning cycle walkthrough, on the card.

The port's counterpart of ``examples/04_improvement_cycle.py``: for a set of
target molecules, generate structural neighbors, simulate their spectra,
fine-tune the model on them and re-test until the teacher-forced sequence
probability clears the threshold. ``steps_per_cycle`` caps each cycle's
training (25, the JAX example's, by default). Runs on the card unless
``main(device="cpu")``.

Run: python3 examples/torch_04_improvement_cycle.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.models import mmt  # noqa: E402
from multimodalspectraltransformer_torch.sim import factory  # noqa: E402
from multimodalspectraltransformer_torch.train import improvement_cycle as ic  # noqa: E402
from multimodalspectraltransformer_torch.train.molgen import MolGenConfig  # noqa: E402
from multimodalspectraltransformer_torch.utils.config import (  # noqa: E402
    MMTConfig, ModelConfig, TrainConfig,
)
from multimodalspectraltransformer_torch.utils.device import resolve_device  # noqa: E402

TARGETS = ["CC(=O)Nc1ccc(O)cc1", "CCOC(=O)c1ccccc1"]


def main(device=None, steps_per_cycle: int = 25) -> list:
    """Run two cycles; returns their reports."""
    dev = resolve_device(device)
    mcfg = ModelConfig(num_encoder_layers=1, num_decoder_layers=2, ffn_dim=256)
    cfg = MMTConfig(model=mcfg, train=TrainConfig(learning_rate=1e-3, num_epochs=2))

    target_records = factory.simulate_records(TARGETS, device=dev)
    print(f"simulated {len(target_records)} targets")

    params = mmt.init_model(mcfg, 0, dev).state_dict()
    icfg = ic.ImprovementCycleConfig(
        max_cycles=2,
        ic_threshold=0.9,  # high threshold so both demo cycles run
        steps_per_cycle=steps_per_cycle,
        molgen=MolGenConfig(generations_per_target=10, max_trials=150),
        include_targets_in_training=True,
    )
    _new_params, reports = ic.run_improvement_cycle(cfg, target_records, params, icfg, device=dev)
    for r in reports:
        print(f"cycle {r.cycle}: {r.n_augmented} augmented molecules, "
              f"train loss {r.train_loss:.3f}, "
              f"corr_sampling_prob {r.summary.corr_sampling_prob:.4f}")
    return reports


if __name__ == "__main__":
    main()
