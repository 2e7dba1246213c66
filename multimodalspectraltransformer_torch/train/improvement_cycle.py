"""The self-improvement fine-tuning cycle.

Counterpart of the JAX package's ``train/improvement_cycle.py`` (reference:
`improvement_cycle_neg_examples_v15_4.py:48-441` and the web variant,
`MMT_website/Runfolder/app.py:634-793`). Per cycle:
(1) generate augmentation molecules around the targets (molgen),
(2) clean them and drop those colliding with the validation set,
(3) blend with train data,
(4) simulate spectra for the augmented set (the GNNs on the device),
(5) fine-tune the MMT (``run_training``),
(6) re-evaluate (``evaluate_molecules``); stop when the teacher-forced
    sequence probability (``corr_sampling_prob``) crosses ``ic_threshold``.

Everything runs on one device, cuda unless the caller asks otherwise. Where
the JAX function takes a PRNG key, this one takes an integer ``seed``: cycle
``c`` evaluates with seed ``fold_seed(seed, c)`` (the counterpart of
``fold_in(rng, c)``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..chem import api as chem
from ..chem.cleaning import clean_smiles_list
from ..data.pipeline import Loader, SampleRecord
from ..eval.harness import EvalSummary, evaluate_molecules
from ..models.mmt import model_from_state_dict
from ..sim import factory as sim_factory
from ..utils.config import DecodeConfig, MMTConfig
from ..utils.device import DeviceLike, resolve_device
from .loop import run_training
from .molgen import MolGenConfig, generate_neighbors, sample_model_neighbors_batch
from .step import fold_seed


@dataclass
class ImprovementCycleConfig:
    max_cycles: int = 5
    ic_threshold: float = 0.6  # corr_sampling_prob target (IC_threshold)
    molgen: MolGenConfig = field(default_factory=MolGenConfig)
    train_blend: int = 0  # extra train records blended per cycle
    steps_per_cycle: int = 0  # 0 = epochs from cfg
    include_targets_in_training: bool = False  # negative-examples mode if False
    eval_mns: bool = False  # full MNS eval per cycle (slower)
    sim_kwargs: dict = field(default_factory=dict)
    # also sample neighbors from the trained MMT decoder itself
    # (molgen.sample_model_neighbors_batch)
    model_neighbors: bool = False
    model_neighbor_fanout: int = 64


@dataclass
class CycleReport:
    cycle: int
    n_augmented: int
    train_loss: float
    summary: EvalSummary
    # host seconds of the cycle's stages: molgen, simulate, train, evaluate
    stage_seconds: dict = field(default_factory=dict)


def _lap(stages: dict, name: str, since: float) -> float:
    """Record the host seconds since ``since`` as stage ``name``; return now."""
    now = time.perf_counter()
    stages[name] = now - since
    return now


def run_improvement_cycle(
    cfg: MMTConfig,
    target_records: list[SampleRecord],
    init_params: dict[str, torch.Tensor],
    icfg: ImprovementCycleConfig = ImprovementCycleConfig(),
    blend_records: Optional[list[SampleRecord]] = None,
    val_smiles: Optional[set] = None,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    should_stop=None,  # optional callable polled before each cycle (job cancel)
    on_cycle=None,  # optional callable(CycleReport): persist progress per cycle
    device: DeviceLike = None,
) -> tuple[dict[str, torch.Tensor], list[CycleReport]]:
    """Returns (the final state dict, per-cycle reports). ``init_params`` is
    a state dict (``import_params_msgpack``'s or a model's); it is not
    modified, and each cycle trains a new model."""
    dev = resolve_device(device)
    params = init_params
    reports: list[CycleReport] = []
    # the collision filter sees val molecules through the SAME clean/stereo-
    # strip transform the augmentation set goes through
    val_canon = set(clean_smiles_list(list(val_smiles or set()))) | {
        chem.canonicalize(s) for s in (val_smiles or set())
    }

    for cycle in range(icfg.max_cycles):
        if should_stop is not None and should_stop():
            break
        stages: dict[str, float] = {}
        clock = time.perf_counter()
        # 1) generate augmentation molecules around each target
        aug_smiles: list[str] = []
        for rec in target_records:
            aug_smiles.extend(generate_neighbors(rec.smiles, icfg.molgen))
        if icfg.model_neighbors:
            for lst in sample_model_neighbors_batch(
                model_from_state_dict(params, cfg.model, dev), target_records, icfg.molgen,
                fanout=icfg.model_neighbor_fanout, device=dev,
            ):
                aug_smiles.extend(lst)
        # 2) dataset-cleaning criteria (reference filter_invalid_criteria),
        # then the validation-set filter (reference mrtf.filter_smiles)
        aug_smiles = clean_smiles_list(aug_smiles)
        aug_smiles = [s for s in aug_smiles if s not in val_canon]
        if icfg.include_targets_in_training:
            # targets pass through the same clean/strip transform so the
            # dedup below recognizes cleaned neighbors as duplicates
            aug_smiles.extend(clean_smiles_list([r.smiles for r in target_records]))
        aug_smiles = list(dict.fromkeys(aug_smiles))
        clock = _lap(stages, "molgen", clock)

        # 3-4) simulate spectra for the augmented set
        sim_records = sim_factory.simulate_records(
            aug_smiles, [f"ic{cycle}_{i}" for i in range(len(aug_smiles))],
            device=dev, **icfg.sim_kwargs,
        )
        clock = _lap(stages, "simulate", clock)
        train_records = list(sim_records)
        if blend_records and icfg.train_blend:
            train_records.extend(blend_records[: icfg.train_blend])
        if not train_records:
            break

        # 5) fine-tune
        loader = Loader(
            train_records, cfg.model,
            batch_size=min(cfg.data.batch_size, max(1, len(train_records))),
            seed=cycle, drop_remainder=False,
        )
        result = run_training(cfg, loader, init_params=params, checkpoint_dir=checkpoint_dir,
                              max_steps=icfg.steps_per_cycle, device=dev)
        model = result.state.model.eval()
        params = model.state_dict()
        clock = _lap(stages, "train", clock)

        # 6) evaluate on the targets
        _, summary = evaluate_molecules(
            target_records, model,
            DecodeConfig(
                # never beyond the decoder's KV-cache/positional table size
                max_len=min(cfg.model.spectrum_points, cfg.model.max_len),
                fanout=32, multinom_runs=5, max_temp_rounds=3,
            ),
            fold_seed(seed, cycle),
            simulate_errors=False,
            run_mns=icfg.eval_mns,
            device=dev,
        )
        _lap(stages, "evaluate", clock)
        reports.append(CycleReport(cycle, len(aug_smiles), result.train_loss, summary, stages))
        if on_cycle is not None:
            on_cycle(reports[-1])
        # long runs are monitored from a log tail: the convergence signal per cycle
        print(
            f"[ic] cycle {cycle}: n_augmented={len(aug_smiles)} "
            f"train_loss={result.train_loss:.4f} "
            f"corr_sampling_prob={summary.corr_sampling_prob:.4f} "
            f"greedy_exact={summary.greedy_exact:.3f}",
            flush=True,
        )
        if summary.corr_sampling_prob > icfg.ic_threshold:
            break
    return params, reports
