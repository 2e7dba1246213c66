#!/usr/bin/env python3
"""The real-experimental-data workflow on the reference's AstraZeneca
molecules, on the card.

The port's counterpart of ``scripts/real_data_demo.py``: 5 molecules with
measured 1H/13C/HSQC/COSY and IR spectra (``--dir``, the AZ example format
that ``data.pipeline.load_real_example`` reads; by default
``MMT_website/Runfolder/CSV_files/website_real_example`` in the repository).
Reference counterpart: the ``/run_model_exp_data`` route
(``MMT_website/app.py:831``) through the ``real_data_linear`` blend head
(``models_MMT_v15_4.py:546, 965-971``), with real-data fine-tuning that
freezes everything but chosen paths (``MT_functions_v15_4.py:124-133``).

Stages: (1) zero-shot evaluation of ``--params`` (full width) on the real
spectra; (2) arm 1, the reference's path: only ``real_data_linear`` trains
(``TrainConfig.trainable_only``, lr ``--lr``) for ``--steps`` steps, leave one
out: each molecule is evaluated through the blend by a head fine-tuned on the
other four (augmented 8x with SMILES variants); (3) arm 2: ``decoder``,
``fc_out`` and ``real_data_linear`` train for ``--steps2`` steps with the
device-side jitter and warp at the measured deviation of these spectra from
the simulator (``measured_sigma``), leave one out too. Frozen tensors stay
bit-equal: they are not given to the optimizer.

Writes ``REAL_DATA_DEMO.json`` (the JAX script's keys) and
``REAL_DATA_DEMO.md`` into ``--out`` (``runs/real_data_demo`` by default;
the committed files at the repository's root are the JAX run's and are never
written). Runs on the card unless ``--device cpu``.

    python3 scripts/torch_real_data_demo.py --params weights/mmt_r4_phase3.msgpack.gz [--dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multimodalspectraltransformer_torch.data.pipeline import REF_TESTSET_DIR  # noqa: E402

REAL_DIR = os.path.join(REF_TESTSET_DIR, "website_real_example")


def evaluate(records, model, dcfg, seed: int = 0, device=None):
    """The harness on ``records`` (simulated errors): per-molecule dicts and
    the summary."""
    from multimodalspectraltransformer_torch.eval import harness

    results, summary = harness.evaluate_molecules(
        records, model, dcfg, seed=seed, simulate_errors=True, device=device)
    mols = []
    for r in results:
        ranked = harness.rank_candidates_by_error(r)
        mols.append({
            "target": r.target,
            "greedy": r.greedy,
            "greedy_valid": r.greedy_valid,
            # harness semantics: greedy_exact canonicalizes both sides;
            # mns_exact is ANY-candidate exact, as harness.summarize counts,
            # so zero-shot and leave-one-out rows are comparable
            "greedy_exact": bool(r.greedy_exact),
            "mns_exact": bool(r.mns_exact),
            "greedy_tanimoto": round(r.greedy_tanimoto, 3),
            "corr_sampling_prob": float(r.corr_sampling_prob),
            "n_candidates": len(r.candidates),
            "best_tanimoto": round(r.best_tanimoto, 3),
            "top3": [
                {"smiles": c.smiles, "tanimoto": round(c.tanimoto, 3),
                 "exact": c.exact}
                for c in ranked[:3]
            ],
        })
    return mols, summary


def agg(mols: list) -> dict:
    """Fold aggregation with the metric definitions of harness.summarize
    (mean over molecules of the per-result fields)."""
    return {
        "greedy_exact": float(np.mean([m["greedy_exact"] for m in mols])),
        "mns_exact": float(np.mean([m["mns_exact"] for m in mols])),
        "best_tanimoto": float(np.mean([m["best_tanimoto"] for m in mols])),
    }


def measured_sigma(records, device=None) -> tuple[float, float]:
    """Per-nucleus NN-MAE of the measured spectra against the simulator on
    the same molecules: the jitter/warp scale that makes the fine-tune's
    domain randomization match the real measurement deviation."""
    from multimodalspectraltransformer_torch.sim import factory

    sims = factory.simulate_records([r.smiles for r in records], device=device)
    d13, d1 = [], []
    for real, sim in zip(records, sims):
        if real.c13 and sim.c13:
            sc = np.asarray([float(x) for x in sim.c13])
            d13 += [float(np.min(np.abs(sc - float(x)))) for x in real.c13]
        if real.h1 and sim.h1:
            sh = np.asarray([float(p[0]) for p in sim.h1])
            d1 += [float(np.min(np.abs(sh - float(p[0])))) for p in real.h1]
    s13 = float(np.mean(d13)) if d13 else 3.0
    s1 = float(np.mean(d1)) if d1 else 0.2
    return s13, s1


def train_fold(params: dict, records: list, held: int, mcfg, trainable: tuple, steps: int,
               lr: float, mixed_precision: bool = True, device=None, **tcfg_extra):
    """``run_training`` from ``params`` (a state dict) on every record but
    ``records[held]``, augmented 8x with SMILES variants, training only the
    parameters whose JAX path holds one of ``trainable``; returns the
    ``TrainResult``."""
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.train.loop import run_training
    from multimodalspectraltransformer_torch.utils.config import (DataConfig, MMTConfig,
                                                                  TrainConfig)

    fold_train = [r for j, r in enumerate(records) if j != held]
    cfg = MMTConfig(
        model=mcfg,
        train=TrainConfig(
            learning_rate=lr, num_epochs=1000, trainable_only=trainable,
            save_interval_steps=10**9, mixed_precision=mixed_precision, **tcfg_extra,
        ),
        data=DataConfig(batch_size=len(fold_train)),
    )
    train_records = dp.augment_records(fold_train, 8, seed=0)
    loader = dp.Loader(
        train_records, mcfg, batch_size=min(16, len(train_records)),
        seed=0, opts=dp.FeaturizeOptions(use_given_smiles_form=True),
    )
    return run_training(cfg, loader, init_params=params, max_steps=steps, log_every=50,
                        device=device)


def run(args, mcfg) -> dict:
    """The three stages at the model configuration ``mcfg`` (``ModelConfig()``
    from ``main``); writes the two files and returns the JSON's content."""
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.train import checkpoint as ckpt
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    records = dp.load_real_example(args.dir)
    print(f"[real] {len(records)} experimental molecules", flush=True)

    params = ckpt.import_params_msgpack(args.params)
    model = mmt.model_from_state_dict(params, mcfg, dev)
    dcfg = DecodeConfig(
        max_len=64, fanout=args.fanout, multinom_runs=10,
        max_temp_rounds=args.rounds, mw_filter=True, compute_dtype="bfloat16",
        greedy_in_pool=True,
    )

    print("[real] zero-shot evaluation...", flush=True)
    zero_mols, zero_sum = evaluate(records, model, dcfg, device=dev)

    # the reference-style real-data fine-tune, leave one out: with 5
    # molecules, fine-tuning and evaluating on overlapping inputs proves
    # nothing, so each molecule is evaluated under a head trained on the
    # other four only, rotated
    blend_mcfg = dataclasses.replace(mcfg, use_real_data=True)

    def loo_arm(label: str, trainable: tuple, steps: int, **tcfg_extra):
        arm_mols = []
        for i, held in enumerate(records):
            print(f"[real] LOO fold {i} ({label}): fine-tuning on the other "
                  f"{len(records) - 1}...", flush=True)
            result = train_fold(params, records, i, blend_mcfg, trainable, steps, args.lr,
                                device=dev, **tcfg_extra)
            fold_mols, _ = evaluate([held], result.state.model.eval(), dcfg, device=dev)
            arm_mols.extend(fold_mols)
        return arm_mols

    # arm 1: the reference's path, the blend head alone
    blend_mols = loo_arm("blend head", ("real_data_linear",), args.steps)
    blend_sum = agg(blend_mols)

    # arm 2: decoder, output head and blend head, with device-side jitter
    # and warp matched to the MEASURED deviation of these spectra from the
    # simulator
    s13, s1 = measured_sigma(records, dev)
    print(f"[real] measured sigma: 13C {s13:.2f} ppm, 1H {s1:.3f} ppm",
          flush=True)
    deco_mols = loo_arm(
        "decoder+blend, jitter-matched",
        ("decoder", "fc_out", "real_data_linear"), args.steps2,
        jitter_13c_ppm=s13, jitter_1h_ppm=s1, jitter_gate_p=0.5,
        warp_13c_ppm=s13, warp_1h_ppm=s1,
    )
    deco_sum = agg(deco_mols)

    out = {
        "zero_shot": {"summary": {"greedy_exact": zero_sum.greedy_exact,
                                  "mns_exact": zero_sum.mns_exact,
                                  "best_tanimoto": zero_sum.avg_best_tanimoto},
                      "molecules": zero_mols},
        "real_data_blend": {"summary": blend_sum, "molecules": blend_mols},
        "real_data_decoder": {"summary": deco_sum, "molecules": deco_mols,
                              "sigma_13c_ppm": s13, "sigma_1h_ppm": s1,
                              "finetune_steps": args.steps2},
        "params": args.params,
        "finetune_steps": args.steps,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "REAL_DATA_DEMO.json"), "w") as f:
        json.dump(out, f, indent=1)
    with open(os.path.join(args.out, "REAL_DATA_DEMO.md"), "w") as f:
        f.write("\n".join(markdown(out, args)) + "\n")
    for key in ("zero_shot", "real_data_blend", "real_data_decoder"):
        print(json.dumps(out[key]["summary"]), flush=True)
    return out


def markdown(out: dict, args) -> list[str]:
    """REAL_DATA_DEMO.md's lines."""
    z, b, d = (out[k]["summary"] for k in ("zero_shot", "real_data_blend", "real_data_decoder"))
    s13, s1 = out["real_data_decoder"]["sigma_13c_ppm"], out["real_data_decoder"]["sigma_1h_ppm"]
    md = [
        "# Real experimental data demo (AstraZeneca molecules)",
        "",
        "The reference ships 5 AZ molecules with MEASURED 1H/13C/HSQC/COSY",
        "+ IR spectra (`website_real_example/`). This runs the framework's",
        "experimental-data workflow on them (reference `/run_model_exp_data`,",
        "`MMT_website/app.py:831`): zero-shot evaluation of the trained",
        "checkpoint, then the reference's real-data fine-tuning path — the",
        f"`real_data_linear` blend head trained alone ({args.steps} steps,",
        "frozen backbone, `TrainConfig.trainable_only`), evaluation through",
        "the blended decode (`models_MMT_v15_4.py:965-971`) under a",
        "**leave-one-out protocol**: each molecule is scored by a blend head",
        "fine-tuned on the other four only, so the fine-tune never sees its",
        "evaluation molecule (5 molecules leave no honest alternative).",
        "",
        "Real spectra are far out of the simulated training domain (measured",
        "shifts, solvent effects, peak-picking noise), so exact recovery on 5",
        "molecules is not expected — the demo evidences the full path runs",
        "end-to-end: candidates generated, CLIP/spectral scoring, ranked",
        "output per molecule.",
        "",
        "| stage | greedy exact | MNS exact | mean best tanimoto |",
        "|---|---|---|---|",
        f"| zero-shot | {z['greedy_exact']:.2f} | {z['mns_exact']:.2f} | {z['best_tanimoto']:.3f} |",
        f"| + blend head (LOO) | {b['greedy_exact']:.2f} | {b['mns_exact']:.2f} | {b['best_tanimoto']:.3f} |",
        f"| + decoder+blend, jitter-matched (LOO) | {d['greedy_exact']:.2f} | {d['mns_exact']:.2f} | {d['best_tanimoto']:.3f} |",
        "",
        f"The decoder arm trains decoder/fc_out/blend for {args.steps2} steps",
        "with device-side jitter+warp at the MEASURED deviation of these",
        f"spectra vs our simulator ({s13:.2f} ppm 13C / {s1:.3f} ppm 1H",
        "NN-MAE) — domain randomization centered on the actual sim2real gap.",
        "",
        "## Per-molecule: zero-shot vs leave-one-out arms",
        "",
        "| molecule | zs best tan | blend LOO | decoder LOO | zs top-rank tan |",
        "|---|---|---|---|---|",
    ]
    for mz, m, md2 in zip(out["zero_shot"]["molecules"], out["real_data_blend"]["molecules"],
                          out["real_data_decoder"]["molecules"]):
        zs_top = mz["top3"][0]["tanimoto"] if mz["top3"] else "-"
        md.append(
            f"| `{m['target'][:40]}` | {mz['best_tanimoto']} | {m['best_tanimoto']} "
            f"| {md2['best_tanimoto']} | {zs_top} |"
        )
    md += ["", f"Checkpoint: `{args.params}`. Reproduce: this script's docstring."]
    return md


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True)
    ap.add_argument("--dir", default=REAL_DIR)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps2", type=int, default=400,
                    help="steps for the decoder+blend jitter-matched arm")
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--fanout", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default=os.path.join("runs", "real_data_demo"),
                    help="directory for REAL_DATA_DEMO.json and .md")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from multimodalspectraltransformer_torch.utils.config import ModelConfig

    run(parse_args(argv), ModelConfig())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
