"""The training loop: epochs, validation, checkpoints, metrics.

Counterpart of the JAX package's ``train/loop.py``: ``run_training`` trains
on the device-resident dataset (``Loader.device_dataset``, batches gathered
on the device) when featurization is deterministic, else on host batches
uploaded by a prefetch thread; applies the warp, jitter and blanking
transforms on the device; steps the plateau schedule once per epoch; runs
validation each epoch; saves checkpoints and, on a crash, a parameter
backup; every ``gen_metrics_every`` steps, greedy-decodes the step's batch
(kernel K1 on the card) and logs ``generation_metrics``: validity,
tanimoto, exact match and the gradient-free auxiliary loss terms (MW,
spectral feedback, tanimoto, validity). ``MetricsLogger`` writes the JSONL
metrics, ``anneal_weights`` gives the annealed loss weights. Data
parallelism (``mesh``) is not ported yet (ROADMAP section 1).
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..chem import api as chem
from ..data import pipeline as dp
from ..decode import samplers
from ..models import mmt
from ..rank import matching
from ..sim import factory as sim_factory
from ..utils import vocab
from ..utils.config import MMTConfig
from ..utils.device import DeviceLike, resolve_device
from . import checkpoint as ckpt_mod
from .state import TrainState, create_state, update_plateau
from .step import (blank_modalities_device, eval_step, fold_generator, jitter_spectra_device,
                   train_step, warp_spectra_device)

# fold_in tags of the batch transforms' random streams (the JAX package's)
_WARP_TAG, _JITTER_TAG, _BLANK_TAG = 0x3A7B, 0x7E77, 0x5BD1


class MetricsLogger:
    """JSONL metrics sink: one dict of scalars per line."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self.history: list[dict] = []

    def log(self, record: dict) -> None:
        record = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                  for k, v in record.items()}
        self.history.append(record)
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class _PrefetchError:
    """Carrier for a worker-thread exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _prefetch(iterator, put_batch, depth: int = 2):
    """Run ``put_batch`` over ``iterator`` ``depth`` items ahead on a worker
    thread. A worker exception is raised in the consumer; abandoning the
    generator stops the worker instead of leaving it blocked on a full
    queue."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(put_batch(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            _put(_PrefetchError(e))
            return
        _put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, _PrefetchError):
                raise item.exc
            yield item
    finally:
        stop.set()


@dataclass
class TrainResult:
    state: TrainState
    train_loss: float
    val_loss: float
    steps: int
    metrics: MetricsLogger


def run_training(
    cfg: MMTConfig,
    train_loader: dp.Loader,
    val_loader: Optional[dp.Loader] = None,
    init_params: Optional[dict[str, torch.Tensor]] = None,
    mesh=None,
    metrics_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    gen_metrics_every: int = 0,
    max_steps: int = 0,  # 0 = run num_epochs
    log_every: int = 1,  # every logged step waits for the device
    device_data: Optional[bool] = None,  # None: the device dataset when it can be made
    device: DeviceLike = None,
) -> TrainResult:
    """Train the MMT on one device (cuda unless asked otherwise), from
    ``init_params`` (a state dict, e.g. ``import_params_msgpack``'s) or the
    JAX package's initializers drawn from ``seed``."""
    if mesh is not None:
        raise NotImplementedError("data parallelism over a mesh is not ported yet "
                                  "(ROADMAP section 1)")
    dev = resolve_device(device)
    if init_params is not None:
        model = mmt.MultimodalTransformer(cfg.model)
        model.load_state_dict(init_params)  # copies: the caller's tensors stay as they are
        model = model.to(dev)
    else:
        model = mmt.init_model(cfg.model, seed, dev)

    dd = None
    if device_data or device_data is None:
        dd = train_loader.device_dataset(dev)

    state = create_state(cfg.train, model)
    manager = None
    if checkpoint_dir:
        manager = ckpt_mod.CheckpointManager(checkpoint_dir, keep=cfg.train.keep_checkpoints,
                                             save_interval_steps=cfg.train.save_interval_steps)
        manager.restore(state)

    logger = MetricsLogger(metrics_path)
    train_loss = float("nan")
    val_loss = float("nan")
    step_count = state.step
    done = bool(max_steps and step_count >= max_steps)  # restored at or over budget
    # a restored run continues the epoch sequence (clamped so it trains)
    start_epoch = step_count // max(1, len(train_loader)) if step_count else 0
    start_epoch = min(start_epoch, max(0, cfg.train.num_epochs - 1))
    put_batch = lambda b: dp.to_device(b, dev)
    t = cfg.train

    try:
        for epoch in range(start_epoch, cfg.train.num_epochs):
            if done:
                break
            if dd is not None:
                batches = (dp.gather_rows(dd, idx) for idx in train_loader.epoch_row_batches(epoch))
            else:
                batches = _prefetch(train_loader.epoch(epoch), put_batch)
            last_m = None
            for b in batches:
                if t.warp_1h_ppm > 0 or t.warp_13c_ppm > 0:
                    b = warp_spectra_device(b, fold_generator(seed, _WARP_TAG, step_count,
                                                              device=dev),
                                            t.warp_1h_ppm, t.warp_13c_ppm, t.jitter_gate_p)
                if t.jitter_1h_ppm > 0 or t.jitter_13c_ppm > 0:
                    b = jitter_spectra_device(b, fold_generator(seed, _JITTER_TAG, step_count,
                                                                device=dev),
                                              t.jitter_1h_ppm, t.jitter_13c_ppm, t.jitter_gate_p)
                if t.blank_percentage > 0:
                    b = blank_modalities_device(b, t.blank_percentage,
                                                fold_generator(seed, _BLANK_TAG, step_count,
                                                               device=dev))
                state, m = train_step(cfg, state, b, seed)
                last_m = m
                step_count += 1
                if step_count % log_every == 0:
                    train_loss = float(m.loss)
                    logger.log({"step": step_count, "epoch": epoch, "train_loss": train_loss,
                                "SMI_loss": m.smi_loss, "FP_loss": m.fp_loss,
                                "token_accuracy": m.token_accuracy, "grad_norm": m.grad_norm})
                if manager is not None and manager.should_save(step_count):
                    manager.save(state, metrics={"loss": float(m.loss)})
                if gen_metrics_every and step_count % gen_metrics_every == 0:
                    logger.log({"step": step_count,
                                **generation_metrics(model, cfg, b, step_count)})
                if max_steps and step_count >= max_steps:
                    done = True
                    break

            # the plateau steps once per epoch on the epoch's last loss
            if last_m is not None:
                train_loss = float(last_m.loss)
            if np.isfinite(train_loss):
                state = update_plateau(cfg.train, state, train_loss)

            if val_loader is not None:
                losses = [float(eval_step(cfg, model, put_batch(batch)).loss)
                          for batch in val_loader.epoch(epoch)]
                if losses:
                    val_loss = float(np.mean(losses))
                    logger.log({"step": step_count, "epoch": epoch, "val_loss": val_loss})
    except Exception:
        # last-resort backup of the parameters on any training exception
        if checkpoint_dir:
            backup = os.path.join(checkpoint_dir, "last_backup_params.msgpack")
            try:
                ckpt_mod.export_params_msgpack(model, backup)
                print(f"run_training: crash backup saved to {backup}")
            except Exception as be:  # noqa: BLE001 - the original error is re-raised
                print(f"run_training: crash backup FAILED ({be!r}); no {backup}")
        raise
    finally:
        logger.close()

    if manager is not None:
        manager.wait()
        manager.close()
    return TrainResult(state, train_loss, val_loss, step_count, logger)


def anneal_weights(step: int, cfg: MMTConfig) -> tuple[float, float]:
    """Loss-weight annealing (the reference's ``change_loss_weights``): every
    ``batch_frequency`` steps weight_MW grows by increment*100 (cap 100) and
    weight_sgnn by increment*10 (cap 10). Returns (weight_mw, weight_sgnn)."""
    t = cfg.train
    if not t.change_loss_weights:
        return t.weight_mw, t.weight_sgnn
    bumps = step // max(t.batch_frequency, 1)
    w_mw = min(100.0, t.weight_mw + bumps * t.increment * 100)
    w_sgnn = min(10.0, t.weight_sgnn + bumps * t.increment * 10)
    return w_mw, w_sgnn


def greedy_generations(model: mmt.MultimodalTransformer, cfg: MMTConfig, batch: dp.TrainBatch
                       ) -> tuple[list[str], list[str]]:
    """The batch's greedy decodes (``spectrum_points`` steps, the model's
    dtype; kernel K1 on the card) and its target SMILES."""
    enc = model.encode(batch.inputs)
    res = samplers.greedy_decode(model.state_dict(), cfg.model, enc.memory,
                                 enc.memory_key_padding_mask, 1.0, cfg.model.spectrum_points,
                                 device=enc.memory.device)
    gen = vocab.batch_ids_to_smiles(res.tokens.cpu().numpy())
    tgt = [vocab.ids_to_smiles(t[1:]) for t in np.asarray(torch.as_tensor(batch.trg_tokens).cpu())]
    return gen, tgt


def generation_metrics(model: mmt.MultimodalTransformer, cfg: MMTConfig, batch: dp.TrainBatch,
                       step: int = 0) -> dict:
    """In-training generation metrics and the reference's gradient-free
    auxiliary loss terms, on the batch's device: greedy validity, mean
    tanimoto over the valid generations, exact match; the min-max-normalized
    MW MSE over valid generations; the spectral feedback error (with
    ``sgnn_feedback``); the annealed weights and ``aux_loss_total``, the
    weighted sum the reference adds to its loss as a plain number."""
    gen, tgt = greedy_generations(model, cfg, batch)
    valid_mask = chem.batch_is_valid(gen)
    validity = float(np.mean(valid_mask)) if len(gen) else 0.0
    tanis = [chem.tanimoto(g, t) or 0.0 for g, t, ok in zip(gen, tgt, valid_mask) if ok]
    tanimoto_mean = float(np.mean(tanis)) if tanis else 0.0

    t = cfg.train
    gen_w = chem.batch_exact_mol_wt([g for g, ok in zip(gen, valid_mask) if ok])
    trg_w = chem.batch_exact_mol_wt([s for s, ok in zip(tgt, valid_mask) if ok])
    pair_ok = ~(np.isnan(gen_w) | np.isnan(trg_w))
    mw_loss = 0.0
    if pair_ok.any():
        gw, tw = gen_w[pair_ok], trg_w[pair_ok]
        lo = min(gw.min(), t.train_weight_min if t.train_weight_min is not None else gw.min())
        hi = max(gw.max(), t.train_weight_max if t.train_weight_max is not None else gw.max())
        span = max(hi - lo, 1e-9)
        mw_loss = float(np.mean(((gw - lo) / span - (tw - lo) / span) ** 2))

    sgnn_error = float("nan")
    if t.sgnn_feedback:
        sgnn_error = spectral_feedback_error(gen, batch, valid_mask)

    w_mw, w_sgnn = anneal_weights(step, cfg)
    aux_total = (w_mw * mw_loss + (w_sgnn * sgnn_error if np.isfinite(sgnn_error) else 0.0)
                 + t.weight_tanimoto * (1.0 - tanimoto_mean)
                 + t.weight_validity * (1.0 - validity))
    return {
        "gen_validity": validity,
        "gen_tanimoto_mean": tanimoto_mean,
        "gen_exact": float(np.mean([chem.exact_match(g, s) for g, s in zip(gen, tgt)])),
        "MW_loss": mw_loss,
        "sgnn_sim_error": sgnn_error,
        "weight_MW": w_mw,
        "weight_sgnn": w_sgnn,
        "aux_loss_total": float(aux_total),
    }


def spectral_feedback_error(gen: list[str], batch: dp.TrainBatch, valid_mask) -> float:
    """The spectral feedback term: the HSQC of the valid generations,
    simulated in one ``simulate_records`` call without IR on the batch's
    device, each scored (``hung_dist_nn``, mean) against the batch's HSQC
    input un-normalized (H*10, C*200); the mean over scored molecules, NaN
    when none is."""
    src = torch.as_tensor(batch.inputs.src_hsqc)
    src_hsqc = src.cpu().numpy()  # [B, P, 2] (H/10, C/200)
    idxs = [i for i, ok in enumerate(valid_mask) if ok]
    if not idxs:
        return float("nan")
    recs = sim_factory.simulate_records([gen[i] for i in idxs], sample_ids=[str(i) for i in idxs],
                                        with_ir=False, device=src.device)
    by_id = {r.sample_id: r for r in recs}
    errors = []
    for i in idxs:
        rec = by_id.get(str(i))
        if rec is None or not rec.hsqc:
            continue
        live = ~(src_hsqc[i] == 0).all(axis=1)
        if not live.any():
            continue
        query = np.stack([src_hsqc[i][live, 0] * 10.0, src_hsqc[i][live, 1] * 200.0], axis=1)
        err = matching.spectral_error(query, np.asarray(rec.hsqc, dtype=np.float64),
                                      mode="hung_dist_nn", error="avg")
        if np.isfinite(err):
            errors.append(err)
    return float(np.mean(errors)) if errors else float("nan")
