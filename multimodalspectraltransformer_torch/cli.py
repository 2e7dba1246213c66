"""Command line of the port.

Subcommands:
  simulate  SMILES (csv/txt) -> simulated spectra CSVs (the data factory)
  train     train the MMT on spectra CSVs, factory-simulated records
            (--factory) or synthetic fixtures (--synthetic)
  train-clip train the CLIP/BLIP contrastive ranking tower against a frozen MMT
  evaluate  run the full evaluation harness, print a metrics JSON
  improve   run the self-improvement fine-tuning cycle
  bench     the headline benchmark (bench_torch.py at the repo root): one JSON line
  serve     run the web serving console (job queue + SSE, port 8083)
  vectorize build a Morgan fingerprint vector DB, optionally query it

Examples:
  python -m multimodalspectraltransformer_torch.cli simulate --smiles mols.txt --out simdata/
  python -m multimodalspectraltransformer_torch.cli train --factory 256 --augment 2 \\
      --bf16 --batch-size 64 --lr 3e-5 --params weights/mmt_r4_phase3.msgpack.gz --out run1/
  python -m multimodalspectraltransformer_torch.cli evaluate --factory 32 \\
      --params weights/mmt_r4_phase3.msgpack.gz
  python -m multimodalspectraltransformer_torch.cli serve --params weights/mmt_r4_phase3.msgpack.gz
  BENCH_MODE=beam python -m multimodalspectraltransformer_torch.cli bench --batch 128 --beam 5
  python -m multimodalspectraltransformer_torch.cli train-clip --factory 1024 --eval-n 64 \
      --batch-size 256 --lr 1e-4 --params weights/mmt_r4_phase3.msgpack.gz --out clip_run/
  python -m multimodalspectraltransformer_torch.cli vectorize --smiles mols.txt --out db --csv \
      --query 'CCO'

Every subcommand runs on ``cuda`` unless ``--device`` says otherwise, and
prints the JSON line of the JAX package's command of the same name. ``train``
and ``improve`` write ``<out>/params.msgpack``, which the JAX package's
``import_params_msgpack`` reads; ``train-clip`` writes the tower as
``<out>/<tower>.msgpack`` and, for CLIP, the bundle ``<out>/clip.msgpack``
with its ``.json``, which ``evaluate --clip-params`` loads. ``--params`` (a
flax msgpack file) or ``--torch-checkpoint`` (a reference ``.pth`` or
Lightning ``.ckpt``) gives the MMT's weights; ``--params`` wins when both
are given.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import os
import pickle
import sys


def _read_smiles(path: str) -> list[str]:
    """SMILES from a CSV (its ``SMILES`` column, else its first) or a text
    file (one per non-blank line)."""
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        if not rows:
            return []
        col = "SMILES" if "SMILES" in rows[0] else next(iter(rows[0]))
        return [row[col] for row in rows]
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def cmd_simulate(args) -> int:
    from .sim import factory
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    records = factory.simulate_records(_read_smiles(args.smiles), device=device)
    paths = factory.export_reference_csvs(records, args.out, run_id=args.run_id)
    print(json.dumps({"n_molecules": len(records), "paths": paths}))
    return 0


def _model_cfg(args):
    from .utils.config import ModelConfig

    return ModelConfig.small() if args.small else ModelConfig()


def _load_records(args, device):
    from .data import pipeline as dp

    if args.factory:
        return _factory_records(args, device)
    if args.synthetic:
        return dp.synthetic_dataset(args.synthetic, seed=args.seed)
    return dp.load_spectra_csvs(csv_1h=args.csv_1h, csv_13c=args.csv_13c, csv_hsqc=args.csv_hsqc,
                                csv_cosy=args.csv_cosy, ir_folder=args.ir_folder, limit=args.limit)


def _factory_records(args, device):
    """``--factory N`` molecules simulated, or read from ``--factory-cache``:
    a pickle keyed by N and the corpus seed, written by this command, by
    ``scripts/torch_build_factory_cache.py`` or by the JAX package's
    counterparts (``data.pipeline.load_records_pickle`` reads it without
    JAX)."""
    from .data import molrandom
    from .data.pipeline import load_records_pickle
    from .sim import factory as sim_factory

    fseed = args.factory_seed if args.factory_seed >= 0 else args.seed
    cache = args.factory_cache
    if cache and os.path.exists(cache):
        cached = load_records_pickle(cache)
        if cached.get("n") != args.factory or cached.get("seed") != fseed:
            raise SystemExit(f"--factory-cache {cache} was generated with n={cached.get('n')} "
                             f"seed={cached.get('seed')}, but this run asked for "
                             f"n={args.factory} seed={fseed}; delete the cache or point "
                             "--factory-cache elsewhere")
        recs = cached["records"]
        if len(recs) > args.factory or len(recs) < args.factory * 0.8:
            print(f"[warn] --factory-cache {cache} holds {len(recs)} records but its key "
                  f"asserts n={args.factory}: the cache looks truncated or over-full; delete "
                  "it to regenerate", file=sys.stderr, flush=True)
        return recs
    smiles = molrandom.random_corpus(args.factory, seed=fseed)
    records = sim_factory.simulate_records(smiles, sample_ids=[f"f{i}" for i in range(len(smiles))],
                                           device=device)
    if cache:
        with open(cache, "wb") as f:
            pickle.dump({"n": args.factory, "seed": fseed, "records": records}, f)
    return records


@contextlib.contextmanager
def _feature_cache(path: str):
    """``MMT_FEATURE_CACHE`` set to ``path`` (when given) for the block."""
    old = os.environ.get("MMT_FEATURE_CACHE")
    if path:
        os.environ["MMT_FEATURE_CACHE"] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MMT_FEATURE_CACHE", None)
        else:
            os.environ["MMT_FEATURE_CACHE"] = old


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
    _check_params(args)
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
    init = _initial_params(args, mcfg)
    with _feature_cache(args.feature_cache):
        result = run_training(
            cfg, loader, val_loader=val, init_params=init,
            metrics_path=os.path.join(args.out, "metrics.jsonl"),
            checkpoint_dir=os.path.join(args.out, "ckpt"),
            seed=args.seed, max_steps=args.steps, gen_metrics_every=args.gen_metrics_every,
            log_every=args.log_every, device=device,
        )
    params_path = os.path.join(args.out, "params.msgpack")
    ckpt.export_params_msgpack(result.state.model, params_path)
    print(json.dumps({"steps": result.steps, "train_loss": result.train_loss,
                      "val_loss": result.val_loss, "params": params_path}))
    return 0


def _check_params(args) -> None:
    if args.params and not os.path.exists(args.params):
        # an explicitly requested checkpoint never falls back to random init
        raise SystemExit(f"--params {args.params!r} does not exist")


def _initial_params(args, mcfg):
    """The MMT state dict that ``--params`` (a flax msgpack file) or else
    ``--torch-checkpoint`` (a reference ``.pth``/``.ckpt``) names, or None."""
    if args.params:
        from .train import checkpoint as ckpt

        return ckpt.import_params_msgpack(args.params)
    if args.torch_checkpoint:
        from .models import convert

        return convert.load_torch_checkpoint(mcfg, args.torch_checkpoint)
    return None


def cmd_evaluate(args) -> int:
    from .eval.harness import evaluate_molecules
    from .models import mmt
    from .utils.config import DecodeConfig
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    mcfg = _model_cfg(args)
    _check_params(args)
    records = _load_records(args, device)
    params = _initial_params(args, mcfg)
    model = (mmt.model_from_state_dict(params, mcfg, device) if params is not None
             else mmt.init_model(mcfg, args.seed, device))
    dcfg = DecodeConfig(
        max_len=args.max_len, fanout=args.fanout,
        multinom_runs=args.multinom_runs, max_temp_rounds=args.rounds,
        mw_filter=not args.no_mw_filter,
        beam_candidates=args.beam_candidates, greedy_in_pool=args.mix,
    )
    clip_bundle = None
    if args.clip_params:
        from .rank import clip as clip_mod

        clip_bundle = clip_mod.load_bundle(args.clip_params, device=device)
    results, summary = evaluate_molecules(
        records, model, dcfg, args.seed,
        simulate_errors=not args.no_sim_errors,
        clip_bundle=clip_bundle,
        clip_block=dcfg.multinom_runs if clip_bundle else 0,
        device=device,
    )
    out = dataclasses.asdict(summary)
    out["top_k_accuracy"] = {str(k): v for k, v in summary.top_k_accuracy.items()}
    print(json.dumps(out))
    if args.results_out:
        import pickle

        with open(args.results_out, "wb") as f:
            pickle.dump(results, f)
    return 0


def cmd_improve(args) -> int:
    from .models import mmt
    from .sim import factory
    from .train import checkpoint as ckpt
    from .train.improvement_cycle import ImprovementCycleConfig, run_improvement_cycle
    from .train.molgen import MolGenConfig
    from .utils.config import DataConfig, MMTConfig, TrainConfig
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    mcfg = _model_cfg(args)
    cfg = MMTConfig(
        model=mcfg,
        train=TrainConfig(learning_rate=args.lr, num_epochs=1, save_interval_steps=10_000),
        data=DataConfig(batch_size=args.batch_size),
    )
    _check_params(args)
    targets = factory.simulate_records(_read_smiles(args.smiles), device=device)
    params = _initial_params(args, mcfg)
    if params is None:
        params = mmt.init_model(mcfg, args.seed, device).state_dict()
    icfg = ImprovementCycleConfig(
        max_cycles=args.cycles,
        ic_threshold=args.threshold,
        molgen=MolGenConfig(generations_per_target=args.generations),
        steps_per_cycle=args.steps,
        include_targets_in_training=args.include_targets,
        model_neighbors=args.model_neighbors,
    )
    os.makedirs(args.out, exist_ok=True)
    cycles_path = os.path.join(args.out, "cycles.jsonl")

    def row(r) -> dict:
        return {"cycle": r.cycle, "n_augmented": r.n_augmented, "train_loss": r.train_loss,
                "corr_sampling_prob": r.summary.corr_sampling_prob,
                "greedy_exact": r.summary.greedy_exact}

    def persist(r) -> None:
        # each cycle's point lands as it comes, so a run cut short keeps its curve
        with open(cycles_path, "a") as f:
            f.write(json.dumps(row(r)) + "\n")

    new_params, reports = run_improvement_cycle(cfg, targets, params, icfg, seed=args.seed,
                                                on_cycle=persist, device=device)
    ckpt.export_params_msgpack(new_params, os.path.join(args.out, "params.msgpack"))
    print(json.dumps([row(r) for r in reports]))
    return 0


def cmd_train_clip(args) -> int:
    from .models import mmt
    from .rank import clip as clip_mod
    from .train import contrastive
    from .utils.config import MMTConfig
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    # an explicit --feature-cache wins; else a "<factory-cache>.featcache"
    # sidecar (one line: the cache directory)
    fc = args.feature_cache
    sidecar = args.factory_cache + ".featcache" if args.factory_cache else ""
    if not fc and sidecar and os.path.exists(sidecar):
        with open(sidecar) as f:
            fc = f.read().strip()
        print(f"[train-clip] feature cache via sidecar: {fc}", flush=True)
    mcfg = _model_cfg(args)
    cfg = MMTConfig(model=mcfg)
    _check_params(args)
    records = _load_records(args, device)
    params = _initial_params(args, mcfg)
    if params is None:
        params = mmt.init_model(mcfg, args.seed, "cpu").state_dict()
    heldout = []
    if args.eval_n > 0:
        heldout, records = records[: args.eval_n], records[args.eval_n :]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    # a run directory's clip_steps_override file replaces --steps (a driver
    # whose command line is fixed corrects its step budget through it)
    steps = args.steps
    override = os.path.join(args.out, "clip_steps_override") if args.out else ""
    if override and os.path.exists(override):
        with open(override) as f:
            steps = int(f.read().strip())
        print(f"[train-clip] steps override: {args.steps} -> {steps} ({override})", flush=True)
    ccfg = contrastive.ContrastiveConfig(learning_rate=args.lr, num_epochs=args.epochs,
                                         batch_size=args.batch_size, max_steps=steps,
                                         log_every=args.log_every, save_every=args.save_every)
    with _feature_cache(fc):
        model, logger = contrastive.train_contrastive(
            cfg, params, records, tower=args.tower, ccfg=ccfg,
            metrics_path=os.path.join(args.out, "metrics.jsonl") if args.out else None,
            checkpoint_path=os.path.join(args.out, f"{args.tower}.msgpack") if args.out else None,
            seed=args.seed, device=device)
    if args.out and args.tower == "clip":
        clip_mod.save_bundle(os.path.join(args.out, "clip.msgpack"), model, model.cfg)
    key = f"{args.tower}_loss"
    last = [r for r in logger.history if key in r]
    out = {"steps": len(last), "final_loss": last[-1][key] if last else None}
    if heldout:
        out["retrieval"] = contrastive.retrieval_accuracy(
            model, cfg, params, heldout, tower=args.tower, batch_size=args.batch_size,
            device=device)
    print(json.dumps(out))
    return 0


def cmd_bench(args) -> int:
    # explicit flags win over any stale BENCH_* exports in the shell
    os.environ["BENCH_BATCH"] = str(args.batch)
    os.environ["BENCH_BEAM"] = str(args.beam)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench_torch

    bench_torch.main(device=args.device)
    return 0


def cmd_serve(args) -> int:
    from .serve import ServerState, serve

    state = ServerState(model_cfg=_model_cfg(args), device=args.device)
    if args.params:
        state.load_checkpoint(args.params)
    serve(port=args.port, state=state)
    return 0


def cmd_vectorize(args) -> int:
    from .eval import vectordb
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    db = vectordb.build_morgan_db(_read_smiles(args.smiles), n_bits=args.bits)
    db.save(args.out)
    if args.csv:
        db.export_csv(args.out + ".csv")
    print(json.dumps({"n": len(db), "out": args.out}))
    if args.query:
        scores, _idx, names, valid = vectordb.query_smiles(db, [args.query], k=args.k,
                                                           device=device)
        if not valid[0]:
            print(json.dumps({"query": args.query, "error": "query SMILES is invalid"}))
            return 1
        print(json.dumps({"query": args.query, "hits": names[0], "scores": scores[0].tolist()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mmst-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda", help="torch device (default cuda)")

    def add_common(sp):
        add_device(sp)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--small", action="store_true", help="2-layer model for quick runs")
        sp.add_argument("--params", default="", help="params.msgpack(.gz) to load")
        sp.add_argument("--torch-checkpoint", default="",
                        help="reference .pth/.ckpt to convert (--params wins)")
        sp.add_argument("--synthetic", type=int, default=0, help="use N synthetic molecules")
        sp.add_argument("--factory", type=int, default=0,
                        help="generate N drug-like molecules and simulate their spectra")
        sp.add_argument("--factory-seed", type=int, default=-1,
                        help="corpus seed (default: --seed)")
        sp.add_argument("--factory-cache", default="",
                        help="pickle cache of the factory records (written by this command or "
                             "the cache builder, of either package)")
        sp.add_argument("--csv-1h", default="")
        sp.add_argument("--csv-13c", default="")
        sp.add_argument("--csv-hsqc", default="")
        sp.add_argument("--csv-cosy", default="")
        sp.add_argument("--ir-folder", default="")
        sp.add_argument("--limit", type=int, default=0)

    sp = sub.add_parser("simulate", help="SMILES -> simulated spectra CSVs")
    add_device(sp)
    sp.add_argument("--smiles", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--run-id", default="0")
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("train", help="train the MMT")
    add_common(sp)
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
    sp.add_argument("--gen-metrics-every", type=int, default=0,
                    help="log greedy generation metrics and the auxiliary loss terms every N "
                         "steps (0: never)")
    sp.add_argument("--feature-cache", default="",
                    help="directory of the featurized-dataset disk cache (MMT_FEATURE_CACHE)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("evaluate", help="run the evaluation harness")
    add_common(sp)
    sp.add_argument("--max-len", type=int, default=64)
    sp.add_argument("--fanout", type=int, default=128)
    sp.add_argument("--multinom-runs", type=int, default=10)
    sp.add_argument("--rounds", type=int, default=20)
    sp.add_argument("--no-mw-filter", action="store_true")
    sp.add_argument("--no-sim-errors", action="store_true")
    sp.add_argument("--beam-candidates", type=int, default=0,
                    help="also pool the top-K beam hypotheses per molecule")
    sp.add_argument("--clip-params", default="",
                    help="trained CLIP bundle (msgpack + .json sidecar) to score candidates with")
    sp.add_argument("--mix", action="store_true",
                    help="also pool the greedy hypothesis (reference sampling_method='mix')")
    sp.add_argument("--results-out", default="", help="pickle the per-molecule results there")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("improve", help="self-improvement fine-tuning cycle")
    add_common(sp)
    sp.add_argument("--smiles", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--lr", type=float, default=5e-5)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--cycles", type=int, default=5)
    sp.add_argument("--threshold", type=float, default=0.6)
    sp.add_argument("--generations", type=int, default=30)
    sp.add_argument("--steps", type=int, default=0)
    sp.add_argument("--include-targets", action="store_true")
    sp.add_argument("--model-neighbors", action="store_true",
                    help="also sample neighbors from the MMT decoder itself")
    sp.set_defaults(fn=cmd_improve)

    sp = sub.add_parser("train-clip", help="train the CLIP/BLIP ranking tower")
    add_common(sp)
    sp.add_argument("--tower", choices=("clip", "blip"), default="clip")
    sp.add_argument("--out", default="")
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--epochs", type=int, default=3)
    sp.add_argument("--steps", type=int, default=0)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--eval-n", type=int, default=0,
                    help="hold out the first N records and report retrieval R@1/R@5 after "
                         "training")
    sp.add_argument("--log-every", type=int, default=50, help="metrics cadence")
    sp.add_argument("--save-every", type=int, default=500,
                    help="tower and optimizer snapshot cadence (<out>/<tower>.msgpack.state)")
    sp.add_argument("--feature-cache", default="",
                    help="featurized-dataset disk cache directory (MMT_FEATURE_CACHE; else a "
                         "<factory-cache>.featcache sidecar file names it)")
    sp.set_defaults(fn=cmd_train_clip)

    sp = sub.add_parser("bench", help="throughput benchmark (bench_torch.py)")
    add_device(sp)
    sp.add_argument("--batch", type=int, default=128)
    sp.add_argument("--beam", type=int, default=5)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("serve", help="web serving console (port 8083)")
    add_device(sp)
    sp.add_argument("--port", type=int, default=8083)
    sp.add_argument("--small", action="store_true")
    sp.add_argument("--params", default="")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("vectorize", help="build a fingerprint vector DB")
    add_device(sp)
    sp.add_argument("--smiles", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--bits", type=int, default=512)
    sp.add_argument("--csv", action="store_true", help="also export reference-format CSV")
    sp.add_argument("--query", default="", help="optionally query one SMILES")
    sp.add_argument("--k", type=int, default=10)
    sp.set_defaults(fn=cmd_vectorize)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
