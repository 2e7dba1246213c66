"""Whether the trainers give the same parameters run after run on the card,
and what a step costs three ways.

    python3 scripts/torch_train_determinism.py [--trainer mmt clip blip shift ir]
        [--reps 6] [--det-reps 4] [--former-lookups] [--out FILE]
    python3 scripts/torch_train_determinism.py --step-times [--out FILE]

Each trainer named (default ``mmt``) at its recipe, from the same start,
``--reps`` times with PyTorch's default algorithms and then ``--det-reps``
times under ``torch.use_deterministic_algorithms(True, warn_only=True)``:

- ``mmt``: ``run_training`` from phase3, 5 bf16 steps at batch 64, lr 3e-5,
  on the records of ``chip_smoke.py``'s training phase
  (``random_corpus(256, seed=3133)`` simulated on the card, the training 90%
  augmented 2x), alternately without a mesh and with a one-rank
  ``make_mesh()`` (in a rank over NCCL; gloo on the CPU);
- ``clip`` and ``blip``: 3 tower steps (``train/contrastive.py::tower_step``,
  dropout on) over the frozen phase3 encode in bf16, at batch 256 from the
  committed clip_r4 tower and at batch 32 from ``QFormerConfig()``'s seeded
  init, on the weight-sorted batches of those records augmented 2x;
- ``shift`` and ``ir``: ``sim/distill.py``'s trainers, 5 steps at batch 256
  and 128 from their seeded init on the rule teachers' labels of
  ``random_corpus(1024, seed=11)``.

Every run is held bit for bit against the first; for a run that differs the
script names the step and the tensors whose gradients differed first, and
the tensors that differ at the end. ``--former-lookups`` runs with the
trained lookups as they were before kernel E1 (``F.embedding`` and indexing,
whose CUDA backward sums in a varying order), to find the order-dependent
sources. ``--step-times`` instead times, in this one process with
``CUBLAS_WORKSPACE_CONFIG`` set before the first product, the median bf16
MMT step at batch 64 from phase3 and the CLIP (256) and BLIP (32) steps,
three ways in turn on the same batches: the former lookups, the port's
lookups through E1, and the former under the global deterministic switch.
The rows go to ``--out`` as JSON; the last line is a summary.
``--device cpu --small`` runs the same code on the CPU at 2+2 layers and
narrow towers from seeded inits, batches of 8, 2 steps a run and 3 timed
steps a way.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
CLIP_R4 = os.path.join(REPO, "weights", "clip_r4.msgpack.gz")
# trainer -> (batch, steps) of a run
RECIPES = {"mmt": (64, 5), "clip": (256, 3), "blip": (32, 3), "shift": (256, 5), "ir": (128, 5)}
SMALL_BATCH, SMALL_STEPS, SMALL_TIMED = 8, 2, 3  # --small
sys.path.insert(0, REPO)


class Run(NamedTuple):
    losses: list
    params: dict  # name -> tensor on the CPU
    trace: list  # per step: (names of the gradients, their bit signatures)
    secs: float


def signatures(named) -> tuple[list, "object"]:
    """The names of the (name, parameter) pairs with a gradient and, per
    gradient, the sum of its float32 bit patterns (equal bits give equal
    sums)."""
    import torch

    named = [(n, p.grad) for n, p in named if p.grad is not None]
    sigs = [g.detach().float().contiguous().view(torch.int32).long().sum() for _, g in named]
    return [n for n, _ in named], torch.stack(sigs).cpu()


def compare(run: Run, ref: Run) -> dict:
    """``run`` against ``ref``: losses equal, the tensors that differ at the
    end (largest difference), the first step whose gradients differ and their
    tensors."""
    import torch

    differ = {k: float((v.double() - ref.params[k].double()).abs().max())
              for k, v in run.params.items() if not torch.equal(v, ref.params[k])}
    first = None
    for step, ((names, g), (_, rg)) in enumerate(zip(run.trace, ref.trace)):
        if not torch.equal(g, rg):
            first = (step, [t for t, a, b in zip(names, g.tolist(), rg.tolist()) if a != b])
            break
    return dict(losses_equal=run.losses == ref.losses, tensors_differ=differ,
                first_gradient_difference=first)


def held_runs(runners: list, reps: int, det_reps: int) -> list:
    """``reps`` rounds of every (name, run) in ``runners`` under the default
    algorithms, then ``det_reps`` under the deterministic switch; each run
    held against the very first."""
    import torch

    ref, rows = None, []
    try:
        for det, n in ((False, reps), (True, det_reps)):
            torch.use_deterministic_algorithms(det, warn_only=True)
            for i in range(n):
                for name, run in runners:
                    r = run()
                    ref = ref or r
                    rows.append(dict(deterministic=det, rep=i, run=name, secs=r.secs,
                                     final_loss=r.losses[-1], **compare(r, ref)))
    finally:
        torch.use_deterministic_algorithms(False)
    return rows


def differs(row: dict) -> bool:
    return bool(row["tensors_differ"]) or not row["losses_equal"]


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def mmt_config(small: bool):
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig

    mcfg = ModelConfig.small() if small else ModelConfig()
    return MMTConfig(model=mcfg, train=TrainConfig(learning_rate=3e-5, mixed_precision=True))


def mmt_init(cfg, small: bool) -> dict:
    """phase3's state dict, or a seeded init of the small model."""
    from multimodalspectraltransformer_torch.models import convert, mmt

    if small:
        return mmt.init_model(cfg.model, 0, "cpu").state_dict()
    return convert.from_jax_params(convert.read_msgpack(PHASE3))


def factory_records(dev, n: int = 256) -> list:
    """``random_corpus(n, seed=3133)`` simulated on ``dev``: the records of
    ``chip_smoke.py``'s training phase."""
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import factory

    smiles = molrandom.random_corpus(n, seed=3133)
    return factory.simulate_records(smiles, sample_ids=[f"f{i}" for i in range(len(smiles))],
                                    device=dev)


def mmt_train_records(records, steps: int, batch: int) -> list:
    """The training 90% augmented 2x, cut to ``steps`` batches."""
    from multimodalspectraltransformer_torch.data import pipeline as dp

    n_val = max(1, int(len(records) * 0.1))
    return dp.augment_records(records[:-n_val], 2, seed=0)[: steps * batch]


def mmt_runner(cfg, records, init: dict, dev, steps: int, batch: int, mesh=None) -> Callable:
    """A run: ``run_training`` for ``steps`` steps from ``init``, each step's
    gradients signed as it is taken."""
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.train import loop

    opts = dp.FeaturizeOptions(use_given_smiles_form=True)

    def run() -> Run:
        trace, plain_step = [], loop.train_step

        def traced_step(*args, **kwargs):
            state, m = plain_step(*args, **kwargs)
            trace.append(signatures(state.model.named_parameters()))
            return state, m

        loop.train_step = traced_step
        try:
            loader = dp.Loader(records, cfg.model, batch_size=batch, opts=opts)
            t0 = time.perf_counter()
            res = loop.run_training(cfg, loader, init_params=init, mesh=mesh, max_steps=steps,
                                    device=dev)
            secs = time.perf_counter() - t0
        finally:
            loop.train_step = plain_step
        return Run([h["train_loss"] for h in res.metrics.history],
                   {k: v.cpu() for k, v in res.state.model.state_dict().items()}, trace, secs)

    return run


def rank_runs(records, reps: int, det_reps: int, steps: int, batch: int, small: bool,
              former: bool = False) -> list:
    """In the one rank of a world: the MMT runs without a mesh and with
    ``make_mesh()`` in turn, each held against the first; ``former``: with
    the lookups as they were before kernel E1."""
    import torch

    from multimodalspectraltransformer_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.distributed.get_backend() == "nccl" else torch.device("cpu"))
    cfg = mmt_config(small)
    init = mmt_init(cfg, small)
    runners = [(name, mmt_runner(cfg, records, init, dev, steps, batch, mesh))
               for name, mesh in (("plain", None), ("mesh", parallel.make_mesh()))]
    with todays_lookups() if former else contextlib.nullcontext():
        return held_runs(runners, reps, det_reps)


def tower_batches(dev, mcfg, records, ccfg, n: int) -> list:
    """``n`` batches of the contrastive trainer's device path (weight-sorted
    rows of the device dataset, the corpus's text tokenized once)."""
    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.train import contrastive as con

    loader = dp.Loader(con._drop_truncating_records(records, mcfg), mcfg, ccfg.batch_size,
                       order_strategy=ccfg.order_strategy)
    dd = loader.device_dataset(dev)
    tk, mk = (torch.from_numpy(x).to(dev)
              for x in con.clip_tokenize(loader._device_kept_smiles, ccfg.max_text_len))
    rows, epoch = [], 0
    while len(rows) < n:
        got = list(loader.epoch_row_batches(epoch))
        if not got:
            raise ValueError(f"{len(loader.records)} records make no batch of {ccfg.batch_size}")
        rows += got
        epoch += 1
    out = []
    for idx in rows[:n]:
        ia = torch.from_numpy(idx).to(dev).long()
        out.append((dp.gather_rows(dd, ia).inputs, tk[ia], mk[ia]))
    return out


def tower_records(records) -> list:
    """The towers' corpus: ``records`` augmented 2x with SMILES variants, so
    a batch of 256 fits in an epoch."""
    from multimodalspectraltransformer_torch.data import pipeline as dp

    return dp.augment_records(records, 2, seed=0)


def tower_start(tower: str, dev, small: bool):
    """(the tower on ``dev``, its ContrastiveConfig at the recipe's batch):
    clip_r4 for CLIP, ``QFormerConfig()``'s seeded init for BLIP; narrow
    seeded towers with ``small``."""
    from multimodalspectraltransformer_torch.rank import clip, qformer
    from multimodalspectraltransformer_torch.train import contrastive as con

    ccfg = con.ContrastiveConfig(learning_rate=1e-4, weight_decay=1e-3,
                                 batch_size=RECIPES[tower][0], max_text_len=64,
                                 order_strategy="weight_sorted")
    if small:
        tcfg = (clip.CLIPConfig(text_layers=1, text_heads=2, cb_embedding=32, text_hidden=32,
                                text_ffn=64, projection_dim=16) if tower == "clip" else
                qformer.QFormerConfig(hidden=32, num_heads=2, ffn_dim=64, num_layers=2,
                                      num_queries=4, encoder_width=32, projection_dim=16))
        model = con.make_tower(tower, tcfg)[0]
    elif tower == "clip":
        model = clip.load_bundle(CLIP_R4, device="cpu")[0]
    else:
        model = con.make_tower("blip")[0]
    return model.to(dev), ccfg


def tower_runner(tower: str, model0, mmt_model, batches, ccfg) -> Callable:
    """A run: a copy of ``model0`` and a fresh AdamW take one tower step
    (dropout on) on each of ``batches``."""
    from multimodalspectraltransformer_torch.train import contrastive as con
    from multimodalspectraltransformer_torch.train.step import step_generator

    def run() -> Run:
        model = copy.deepcopy(model0)
        opt = con.make_optimizer(con.trained_parameters(model, tower), ccfg)
        trace, losses = [], []
        t0 = time.perf_counter()
        for i, (inputs, toks, mask) in enumerate(batches):
            enc = con._encode_frozen(mmt_model, inputs)
            losses.append(float(con.tower_step(model, opt, tower, enc, toks, mask,
                                               ccfg.temperature, step_generator(0, i))))
            trace.append(signatures(model.named_parameters()))
        secs = time.perf_counter() - t0
        return Run(losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}, trace,
                   secs)

    return run


def distill_data(n: int = 1024) -> dict:
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import distill

    return distill.build_teacher_dataset(molrandom.random_corpus(n, seed=11))


def distill_runner(name: str, data: dict, dev, steps: int, batch: int) -> Callable:
    """A run: ``steps`` steps of the shift or IR trainer from its seeded
    init, each step's gradients signed before the update."""
    from multimodalspectraltransformer_torch.sim import distill

    train = distill.train_shift_model if name == "shift" else distill.train_ir_model

    def run() -> Run:
        grads, step = [], distill.OptaxAdamW.step

        def recording(opt, lr):
            grads.append(signatures((str(i), p) for i, p in enumerate(opt.params)))
            step(opt, lr)

        distill.OptaxAdamW.step = recording
        try:
            t0 = time.perf_counter()
            res = train(data, batch_size=batch, n_steps=steps, log_every=0, device=dev)
            secs = time.perf_counter() - t0
        finally:
            distill.OptaxAdamW.step = step
        model, rep = res[0], res[-1]
        names = [n for n, _ in model.named_parameters()]
        trace = [([names[int(i)] for i in idx], sig) for idx, sig in grads]
        return Run([rep["final_loss"]], {k: v.detach().cpu() for k, v in model.state_dict().items()},
                   trace, secs)

    return run


def trainer_runs(trainer: str, dev, reps: int, det_reps: int, records=None,
                 small: bool = False) -> list:
    """The held runs of ``trainer`` in this process (the MMT without a mesh);
    ``records``: the factory records of the MMT and the towers (simulated here
    when None)."""
    batch, steps = (SMALL_BATCH, SMALL_STEPS) if small else RECIPES[trainer]
    if trainer in ("shift", "ir"):
        runner = distill_runner(trainer, distill_data(64 if small else 1024), dev, steps, batch)
        return held_runs([("plain", runner)], reps, det_reps)
    records = records if records is not None else factory_records(dev, 16 if small else 256)
    cfg = mmt_config(small)
    if trainer == "mmt":
        runner = mmt_runner(cfg, mmt_train_records(records, steps, batch), mmt_init(cfg, small),
                            dev, steps, batch)
        return held_runs([("plain", runner)], reps, det_reps)
    from multimodalspectraltransformer_torch.train import contrastive as con

    model, ccfg = tower_start(trainer, dev, small)
    ccfg = dataclasses.replace(ccfg, batch_size=batch)
    mmt_model = con._encode_model(cfg.model, mmt_init(cfg, small), dev)
    batches = tower_batches(dev, cfg.model, tower_records(records), ccfg, steps)
    return held_runs([("plain", tower_runner(trainer, model, mmt_model, batches, ccfg))], reps,
                     det_reps)


# ---------------------------------------------------------------------------
# the step times, three ways
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def todays_lookups():
    """The trained lookups as the port read them before kernel E1: the MMT's
    and the Q-Former's through ``F.embedding``, CLIP's by indexing the cast
    table."""
    import torch.nn.functional as F

    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.rank import clip, qformer

    saved = [(m, m.embedding_lookup) for m in (mmt, clip, qformer)]
    mmt.embedding_lookup = qformer.embedding_lookup = lambda w, ids: F.embedding(ids.long(), w)
    clip.embedding_lookup = lambda w, ids: w[ids.long()]
    try:
        yield
    finally:
        for m, fn in saved:
            m.embedding_lookup = fn


WAYS = ("today", "e1", "switch")  # the former lookups, kernel E1, the former under the switch


@contextlib.contextmanager
def way(name: str):
    import torch

    with contextlib.ExitStack() as stack:
        if name != "e1":
            stack.enter_context(todays_lookups())
        if name == "switch":
            torch.use_deterministic_algorithms(True, warn_only=True)
            stack.callback(torch.use_deterministic_algorithms, False)
        yield


def interleaved_ms(steppers: dict, n_batches: int, warmup: int, rounds: int, sync) -> dict:
    """Each way's step ``i`` on batch ``i``: ``warmup`` steps of each way,
    then ``rounds`` rounds in which each way, in an order rotated every round,
    takes its next ``(n_batches - warmup) // rounds`` steps; host clock to the
    loss read back. -> way -> (median ms, every timed ms)."""
    times = {w: [] for w in WAYS}
    nxt = {w: 0 for w in WAYS}
    per = max(1, (n_batches - warmup) // rounds)
    for w in WAYS:
        with way(w):
            for _ in range(warmup):
                steppers[w](nxt[w])
                nxt[w] += 1
    for r in range(rounds):
        for w in WAYS[r % 3:] + WAYS[: r % 3]:
            with way(w):
                for _ in range(per):
                    sync()
                    t0 = time.perf_counter()
                    steppers[w](nxt[w])
                    times[w].append((time.perf_counter() - t0) * 1e3)
                    nxt[w] += 1
    return {w: (float(np.median(t)), t) for w, t in times.items()}


def step_times(dev, records, timed: int = 12, small: bool = False) -> dict:
    """The three ways' median step (ms) of the bf16 MMT at batch 64 from
    phase3 and of the CLIP (256) and BLIP (32) towers, interleaved on the
    same batches, with the E1 launches a step."""
    import torch

    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.ops import embedding_grad as e1
    from multimodalspectraltransformer_torch.train import contrastive as con
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.train.step import step_generator

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    warmup, rounds = 3, timed  # one step of each way a round
    n = warmup + timed
    cfg = mmt_config(small)
    init = mmt_init(cfg, small)
    out = {}

    batch = SMALL_BATCH if small else RECIPES["mmt"][0]
    loader = dp.Loader(mmt_train_records(records, n, batch), cfg.model, batch_size=batch,
                       opts=dp.FeaturizeOptions(use_given_smiles_form=True))
    dd = loader.device_dataset(dev)
    rows, epoch = [], 0
    while len(rows) < n:
        rows += list(loader.epoch_row_batches(epoch))
        epoch += 1
    states = {}
    for w in WAYS:
        model = mmt.MultimodalTransformer(cfg.model)
        model.load_state_dict(init)
        states[w] = st.create_state(cfg.train, model.to(dev))
    mmt_steps = {w: (lambda i, w=w: float(step.train_step(cfg, states[w],
                                                          dp.gather_rows(dd, rows[i]))[1].loss))
                 for w in WAYS}
    e1.reset_launches()
    mmt_steps["e1"](0)
    per_step = e1.launches
    res = interleaved_ms(mmt_steps, n, warmup, rounds, sync)
    out["mmt"] = dict(batch=batch, e1_launches_a_step=per_step,
                      median_ms={w: res[w][0] for w in WAYS}, ms={w: res[w][1] for w in WAYS})
    del states, dd

    mmt_model = con._encode_model(cfg.model, init, dev)
    for tower in ("clip", "blip"):
        model0, ccfg = tower_start(tower, dev, small)
        if small:
            ccfg = dataclasses.replace(ccfg, batch_size=SMALL_BATCH)
        batches = tower_batches(dev, cfg.model, tower_records(records), ccfg, n)
        models = {w: copy.deepcopy(model0) for w in WAYS}
        opts = {w: con.make_optimizer(con.trained_parameters(models[w], tower), ccfg)
                for w in WAYS}

        def tower_step(i, w, tower=tower, batches=batches, models=models, opts=opts, ccfg=ccfg):
            inputs, toks, mask = batches[i]
            enc = con._encode_frozen(mmt_model, inputs)
            return float(con.tower_step(models[w], opts[w], tower, enc, toks, mask,
                                        ccfg.temperature, step_generator(0, i)))

        steppers = {w: (lambda i, w=w, f=tower_step: f(i, w)) for w in WAYS}
        e1.reset_launches()
        steppers["e1"](0)
        per_step = e1.launches
        res = interleaved_ms(steppers, n, warmup, rounds, sync)
        out[tower] = dict(batch=ccfg.batch_size, e1_launches_a_step=per_step,
                          median_ms={w: res[w][0] for w in WAYS}, ms={w: res[w][1] for w in WAYS})
        del models, opts, model0
    return out


# ---------------------------------------------------------------------------

def report(trainer: str, rows: list, card: str) -> dict:
    """Print each run that differs and the counts; -> the counts."""
    for r in rows:
        if differs(r):
            print(f"differs: {trainer}, {'deterministic' if r['deterministic'] else 'default'} "
                  f"algorithms, {r['run']} run {r['rep']}: losses "
                  f"{'equal' if r['losses_equal'] else 'differ'}, first gradient difference "
                  f"{r['first_gradient_difference']}, at the end {r['tensors_differ']}")
    summary = {}
    for det in (False, True):
        sel = [r for r in rows if r["deterministic"] == det]
        key = "deterministic" if det else "default"
        summary[key] = dict(runs=len(sel), differ=sum(map(differs, sel)),
                            secs_a_run=sum(r["secs"] for r in sel) / max(1, len(sel)))
        print(f"{trainer}, {key} algorithms: {summary[key]['differ']} of {len(sel)} runs differ "
              f"from the first; {summary[key]['secs_a_run']:.2f} s a run; {card}")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainer", choices=sorted(RECIPES), nargs="+", default=["mmt"])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--det-reps", type=int, default=4)
    ap.add_argument("--former-lookups", action="store_true",
                    help="run with the lookups as they were before kernel E1")
    ap.add_argument("--step-times", action="store_true",
                    help="time the steps three ways instead of repeating runs")
    ap.add_argument("--small", action="store_true",
                    help="2+2 layers, narrow towers and short runs (for the CPU)")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", default=None,
                    help="JSON output (default: runs/train_determinism.json, "
                         "runs/train_step_times.json with --step-times)")
    args = ap.parse_args(argv)

    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # the card unless asked; raises without one
    if args.step_times or args.det_reps:
        # cuBLAS is bitwise reproducible under the switch only with a fixed
        # workspace, which must be set before the first product
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    name = "train_step_times.json" if args.step_times else "train_determinism.json"
    out = args.out or os.path.join(REPO, "runs", name)
    records = factory_records(dev, 16 if args.small else 256)

    if args.step_times:
        res = step_times(dev, records, SMALL_TIMED if args.small else 12, args.small)
        doc = dict(torch=torch.__version__, card=card, step_times=res)
        summary = {k: dict(batch=v["batch"], e1_launches_a_step=v["e1_launches_a_step"],
                           **{f"{w}_ms": v["median_ms"][w] for w in WAYS}) for k, v in res.items()}
    else:
        doc = dict(torch=torch.__version__, card=card, former_lookups=args.former_lookups, runs={})
        summary = dict(former_lookups=args.former_lookups)
        for trainer in args.trainer:
            if trainer == "mmt":
                from multimodalspectraltransformer_torch.parallel.launch import launch

                batch, steps = (SMALL_BATCH, SMALL_STEPS) if args.small else RECIPES["mmt"]
                sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # the rank's import
                rows = launch("torch_train_determinism:rank_runs", 1,
                              args=(mmt_train_records(records, steps, batch), args.reps,
                                    args.det_reps, steps, batch, args.small, args.former_lookups),
                              device=dev, timeout=1800)[0]
            else:
                with todays_lookups() if args.former_lookups else contextlib.nullcontext():
                    rows = trainer_runs(trainer, dev, args.reps, args.det_reps, records=records,
                                        small=args.small)
            doc["runs"][trainer] = rows
            summary[trainer] = report(trainer, rows, card)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(dict(card=card, **summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
