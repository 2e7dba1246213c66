"""Command line of the port.

Subcommands:
  train   train the MMT on spectra CSVs, factory-simulated records
          (--factory) or synthetic fixtures (--synthetic)

Example:
  python -m multimodalspectraltransformer_torch.cli train --factory 256 --augment 2 \\
      --bf16 --batch-size 64 --lr 3e-5 --params weights/mmt_r4_phase3.msgpack.gz --out run1/

Runs on ``cuda`` unless ``--device`` says otherwise. Prints the JAX package's
``cli train`` JSON line (steps, train_loss, val_loss, params) and writes
``<out>/params.msgpack``, which the JAX package's ``import_params_msgpack``
reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _model_cfg(args):
    from .utils.config import ModelConfig

    return ModelConfig.small() if args.small else ModelConfig()


def _load_records(args, device):
    from .data import pipeline as dp

    if args.factory:
        from .data import molrandom
        from .sim import factory as sim_factory

        fseed = args.factory_seed if args.factory_seed >= 0 else args.seed
        smiles = molrandom.random_corpus(args.factory, seed=fseed)
        return sim_factory.simulate_records(smiles, sample_ids=[f"f{i}" for i in range(len(smiles))],
                                            device=device)
    if args.synthetic:
        return dp.synthetic_dataset(args.synthetic, seed=args.seed)
    return dp.load_spectra_csvs(csv_1h=args.csv_1h, csv_13c=args.csv_13c, csv_hsqc=args.csv_hsqc,
                                csv_cosy=args.csv_cosy, ir_folder=args.ir_folder, limit=args.limit)


def cmd_train(args) -> int:
    from .data.pipeline import FeaturizeOptions, Loader, augment_records
    from .train import checkpoint as ckpt
    from .train.loop import run_training
    from .utils.config import DataConfig, MMTConfig, TrainConfig
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    mcfg = _model_cfg(args)
    cfg = MMTConfig(
        model=mcfg,
        train=TrainConfig(
            learning_rate=args.lr, num_epochs=args.epochs, save_interval_steps=args.save_every,
            mixed_precision=args.bf16, blank_percentage=args.blank,
            jitter_1h_ppm=args.jitter_1h, jitter_13c_ppm=args.jitter_13c,
            warp_1h_ppm=args.warp_1h, warp_13c_ppm=args.warp_13c,
            ss_prob=args.ss_prob, ss_ramp_steps=args.ss_ramp,
        ),
        data=DataConfig(batch_size=args.batch_size),
    )
    if args.params and not os.path.exists(args.params):
        # an explicitly requested checkpoint never falls back to random init
        raise SystemExit(f"--params {args.params!r} does not exist")
    records = _load_records(args, device)
    if not records:
        print(json.dumps({"error": "no records loaded"}))
        return 1
    n_val = max(1, int(len(records) * 0.1))
    if args.val_n:
        n_val = min(n_val, args.val_n)
    n_train = len(records) - n_val
    if n_train < 1:
        print(json.dumps({"error": f"{len(records)} records is too few to split train/val"}))
        return 1
    train_records = records[:-n_val]
    opts = FeaturizeOptions(blank_percentage=args.blank_host,
                            randomize_smiles=args.randomize_smiles,
                            use_given_smiles_form=args.augment > 1)
    if args.augment > 1:
        train_records = augment_records(train_records, args.augment, seed=args.seed)
        print(f"augmented {n_train} -> {len(train_records)} records", file=sys.stderr)
    # clamp after augmentation: the expanded set may fill the batch
    bs = max(1, min(args.batch_size, len(train_records)))
    if bs != args.batch_size:
        print(f"note: batch size clamped to {bs} ({len(train_records)} training records)",
              file=sys.stderr)
    loader = Loader(train_records, mcfg, batch_size=bs, seed=args.seed, opts=opts)
    val = Loader(records[-n_val:], mcfg, batch_size=min(bs, n_val), seed=args.seed,
                 drop_remainder=False)

    os.makedirs(args.out, exist_ok=True)
    init = ckpt.import_params_msgpack(args.params) if args.params else None
    result = run_training(
        cfg, loader, val_loader=val, init_params=init,
        metrics_path=os.path.join(args.out, "metrics.jsonl"),
        checkpoint_dir=os.path.join(args.out, "ckpt"),
        seed=args.seed, max_steps=args.steps, log_every=args.log_every, device=device,
    )
    params_path = os.path.join(args.out, "params.msgpack")
    ckpt.export_params_msgpack(result.state.model, params_path)
    print(json.dumps({"steps": result.steps, "train_loss": result.train_loss,
                      "val_loss": result.val_loss, "params": params_path}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mmst-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("train", help="train the MMT")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--small", action="store_true", help="2-layer model for quick runs")
    sp.add_argument("--params", default="", help="params.msgpack(.gz) to start from")
    sp.add_argument("--synthetic", type=int, default=0, help="use N synthetic molecules")
    sp.add_argument("--factory", type=int, default=0,
                    help="generate N drug-like molecules and simulate their spectra")
    sp.add_argument("--factory-seed", type=int, default=-1, help="corpus seed (default: --seed)")
    sp.add_argument("--csv-1h", default="")
    sp.add_argument("--csv-13c", default="")
    sp.add_argument("--csv-hsqc", default="")
    sp.add_argument("--csv-cosy", default="")
    sp.add_argument("--ir-folder", default="")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--out", required=True)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--epochs", type=int, default=10)
    sp.add_argument("--steps", type=int, default=0)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--save-every", type=int, default=1000)
    sp.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute with float32 master parameters")
    sp.add_argument("--val-n", type=int, default=0,
                    help="cap the validation split at N records (default: 10%% of the corpus)")
    sp.add_argument("--log-every", type=int, default=10,
                    help="metrics cadence; every log waits for the device")
    sp.add_argument("--randomize-smiles", action="store_true",
                    help="per-epoch SMILES randomization (forces host featurization)")
    sp.add_argument("--augment", type=int, default=1,
                    help="pre-expanded SMILES-variant augmentation factor (keeps the "
                         "device-resident dataset)")
    sp.add_argument("--blank", type=float, default=0.0,
                    help="per-sample modality blanking probability, applied on the device")
    sp.add_argument("--jitter-1h", type=float, default=0.0,
                    help="per-peak 1H ppm jitter sigma (half the samples of a batch)")
    sp.add_argument("--jitter-13c", type=float, default=0.0,
                    help="per-peak 13C ppm jitter sigma")
    sp.add_argument("--warp-1h", type=float, default=0.0,
                    help="smooth 1H-axis warp sigma (ppm), the same on 1H, HSQC H and COSY")
    sp.add_argument("--warp-13c", type=float, default=0.0,
                    help="smooth 13C-axis warp sigma (ppm), the same on 13C and HSQC C")
    sp.add_argument("--ss-prob", type=float, default=0.0,
                    help="two-pass scheduled-sampling probability")
    sp.add_argument("--ss-ramp", type=int, default=2000,
                    help="steps to ramp --ss-prob from 0 to its full value")
    sp.add_argument("--blank-host", type=float, default=0.0,
                    help="host-side blanking during featurization (forces the host path)")
    sp.set_defaults(fn=cmd_train)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
