"""Contrastive (CLIP / BLIP) training of the ranking towers.

Counterpart of the JAX package's ``train/contrastive.py``: a CLIP tower
(``rank/clip.py``, over the MMT fingerprint) or a BLIP tower
(``rank/qformer.py``, over the MMT memory) trains against a frozen MMT whose
encode runs in bfloat16 over float32 parameters, without gradients; batches
come in molecular-weight order (``weight_sorted``, hard negatives) from the
``Loader``, gathered on the device from the device-resident dataset when it
can be made, with the text tokenized once for the whole corpus.

Each step: the frozen encode, then ``tower_step``: the tower's loss with
dropout drawn from ``(seed, step)``, the backward pass and one AdamW update
with optax's ``adamw`` settings (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
decay ``weight_decay`` on every parameter); the loss is read back every
step, as the JAX loop does. Every ``save_every`` steps the tower and its
optimizer go to ``<checkpoint>.state`` (``torch.save``, written to a
temporary name and moved into place), and a later call with the same
checkpoint path resumes from it; on any exception the tower is exported to
``<checkpoint>.backup.msgpack``; at the end to ``<checkpoint>``, in the JAX
package's flax msgpack tree. ``retrieval_accuracy`` gives R@1/R@5 in both
directions over held-out records.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..chem import tokenizer as chem_tokenizer
from ..data import pipeline as dp
from ..models import mmt
from ..models.convert import to_jax_blip_params, to_jax_clip_params, write_msgpack
from ..rank import clip as clip_mod
from ..rank import qformer as qformer_mod
from ..utils import vocab
from ..utils.config import MMTConfig
from ..utils.device import DeviceLike, resolve_device
from .loop import MetricsLogger
from .step import step_generator


def clip_tokenize(smiles_list, max_len: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Framed character-level ids for the text tower and the attention mask
    (1 = real token), int32 [len(smiles_list), max_len] each."""
    toks = np.zeros((len(smiles_list), max_len), np.int32)
    mask = np.zeros((len(smiles_list), max_len), np.int32)
    for i, s in enumerate(smiles_list):
        ids, pad_mask = chem_tokenizer.encode_smiles_framed(s, max_len)
        toks[i] = ids
        mask[i] = 1 - np.asarray(pad_mask, np.int32)
    return toks, mask


@dataclass
class ContrastiveConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-3
    num_epochs: int = 3
    batch_size: int = 32
    max_text_len: int = 64
    order_strategy: str = "weight_sorted"  # hard negatives (the reference's default)
    temperature: float = 1.0
    max_steps: int = 0
    log_every: int = 1  # metrics cadence
    save_every: int = 500  # <checkpoint>.state cadence; 0 disables


def make_tower(tower: str, tower_cfg=None, text_tower_cfg=None, memory_width: int = 128):
    """A tower with the JAX package's initializers (drawn from seed 1, as the
    JAX trainer's ``PRNGKey(1)``), and its configs: (CLIPRanker, CLIPConfig,
    None) or (BLIPRanker, QFormerConfig, text CLIPConfig). ``memory_width``:
    the MMT's hidden size (BLIP)."""
    if tower == "clip":
        tcfg = tower_cfg or clip_mod.CLIPConfig()
        return qformer_mod.init_tower(clip_mod.CLIPRanker(tcfg), 1), tcfg, None
    if tower != "blip":
        raise ValueError(f"tower must be 'clip' or 'blip', got {tower!r}")
    qcfg = tower_cfg or qformer_mod.QFormerConfig()
    text_cfg = text_tower_cfg or qformer_mod.default_text_config(qcfg)
    model = qformer_mod.BLIPRanker(qcfg, text_cfg, memory_width)
    return qformer_mod.init_tower(model, 1), qcfg, text_cfg


def trained_parameters(model: nn.Module, tower: str) -> list[nn.Parameter]:
    """The parameters the contrastive objective trains: all of a CLIP tower;
    of a BLIP tower, all but the Q-Former's text rows and the ITM and LM
    heads (``qformer.is_contrastive_param``)."""
    named = model.named_parameters()
    return [p for n, p in named if tower == "clip" or qformer_mod.is_contrastive_param(n)]


def make_optimizer(params, ccfg: ContrastiveConfig) -> torch.optim.Optimizer:
    """optax's ``adamw(lr, weight_decay=wd)``: b1 0.9, b2 0.999, eps 1e-8,
    decay applied to every parameter (torch's default decay would be 0.01)."""
    return torch.optim.AdamW(params, lr=ccfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=ccfg.weight_decay)


def tower_state_dict(model: nn.Module, tower: str) -> dict[str, torch.Tensor]:
    """The tower's state dict as the JAX trainer's tree holds it (a BLIP
    tower without its ITM/LM-only leaves)."""
    return model.state_dict() if tower == "clip" else model.contrastive_state_dict()


def export_tower(model: nn.Module, tower: str, path: str) -> None:
    """``{"params": ...}`` of the tower as a flax msgpack file (the JAX
    trainer's ``export_params_msgpack``)."""
    to_tree = to_jax_clip_params if tower == "clip" else to_jax_blip_params
    write_msgpack(to_tree(tower_state_dict(model, tower)), path)


def tower_loss(model: nn.Module, tower: str, enc: tuple, tokens: torch.Tensor,
               mask: torch.Tensor, temperature: float,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The contrastive loss of a batch: ``enc`` = (fingerprint, memory, key
    padding mask) of the frozen encode (float32)."""
    fp, memory, kpm = enc
    if tower == "clip":
        cb, mt = model(tokens, mask, fp, generator=generator)
        return clip_mod.clip_loss(cb, mt, temperature).mean_loss
    text, spec = model(tokens, mask, memory, kpm, generator=generator)
    return qformer_mod.blip_loss(text, spec, temperature).mean_loss


def tower_step(model: nn.Module, optimizer: torch.optim.Optimizer, tower: str, enc: tuple,
               tokens: torch.Tensor, mask: torch.Tensor, temperature: float,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One training step of the tower on a frozen encode: loss, gradients,
    one AdamW update. A trained parameter without a gradient takes a zero
    one, so its weight decay still applies, as in optax. -> the loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = tower_loss(model, tower, enc, tokens, mask, temperature, generator)
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach()


def save_snapshot(path: str, model: nn.Module, tower: str, optimizer: torch.optim.Optimizer,
                  step: int) -> None:
    """The tower, its optimizer and the step as ``path`` (``torch.save``),
    written to a per-process temporary name and moved into place."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"params": tower_state_dict(model, tower), "opt_state": optimizer.state_dict(),
                "step": step}, tmp)
    os.replace(tmp, path)


def load_snapshot(path: str, model: nn.Module, tower: str, optimizer: torch.optim.Optimizer
                  ) -> int:
    """Restore a ``save_snapshot`` file into ``model`` and ``optimizer`` ->
    its step."""
    dev = next(model.parameters()).device
    snap = torch.load(path, map_location=dev, weights_only=True)
    _load_tower(model, tower, snap["params"])
    optimizer.load_state_dict(snap["opt_state"])
    return int(snap["step"])


def _encode_model(mcfg, mmt_params: dict, device) -> mmt.MultimodalTransformer:
    """The frozen MMT: bfloat16 compute over float32 parameters, eval mode,
    no parameter requiring a gradient."""
    model = mmt.model_from_state_dict(mmt_params, dataclasses.replace(mcfg, dtype="bfloat16"),
                                      device)
    return model.requires_grad_(False)


@torch.no_grad()
def _encode_frozen(mmt_model: mmt.MultimodalTransformer, inputs: mmt.MMTBatch) -> tuple:
    """The frozen encode -> (fingerprint, memory, key padding mask), the
    first two cast to float32 so the tower's numerics do not depend on the
    encode's dtype."""
    enc = mmt_model.encode(inputs)
    return enc.fingerprint.float(), enc.memory.float(), enc.memory_key_padding_mask


def _drop_truncating_records(records, mcfg) -> list:
    """Drop records whose SMILES would not fit the decoder target's framing
    (``spectrum_points - 2`` tokens): ``_batch_smiles`` reads the text back
    from the target tokens, and a cut molecule would pair its spectrum with
    another string."""
    kept = [r for r in records
            if len(chem_tokenizer.encode_smiles(r.smiles)) <= mcfg.spectrum_points - 2]
    if len(kept) != len(records):
        print(f"contrastive: dropped {len(records) - len(kept)} records whose SMILES exceed "
              f"the {mcfg.spectrum_points - 2}-token trg framing")
    return kept


def _batch_smiles(batch: dp.TrainBatch) -> list[str]:
    return [vocab.ids_to_smiles(t[1:]) for t in np.asarray(batch.trg_tokens)]


def _load_tower(model: nn.Module, tower: str, sd: dict) -> None:
    """Load ``sd`` into the tower: all of a CLIP tower's keys; at least the
    contrastive keys of a BLIP tower (the ITM/LM-only leaves may be absent)."""
    missing, unexpected = model.load_state_dict(sd, strict=tower == "clip")
    if unexpected or any(qformer_mod.is_contrastive_param(k) for k in missing):
        raise KeyError(f"tower weights do not fit: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")


def train_contrastive(
    mmt_cfg: MMTConfig,
    mmt_params: dict,
    records: list,
    tower: str = "clip",
    ccfg: ContrastiveConfig = ContrastiveConfig(),
    tower_cfg=None,
    text_tower_cfg=None,
    init_variables: Optional[dict] = None,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> tuple[nn.Module, MetricsLogger]:
    """Train a CLIP or BLIP tower against the frozen MMT (``mmt_params``, a
    state dict) on ``device`` (cuda unless asked otherwise), from
    ``init_variables`` (a tower state dict) or the JAX package's
    initializers. Returns (the tower, the metrics logger)."""
    dev = resolve_device(device)
    if tower not in ("clip", "blip"):
        raise ValueError(tower)
    mmt_model = _encode_model(mmt_cfg.model, mmt_params, dev)
    model, *_ = make_tower(tower, tower_cfg, text_tower_cfg, mmt_cfg.model.hidden_size)
    if init_variables is not None:
        _load_tower(model, tower, init_variables)
    model = model.to(dev)

    records = _drop_truncating_records(records, mmt_cfg.model)
    loader = dp.Loader(records, mmt_cfg.model, ccfg.batch_size, seed=seed,
                       order_strategy=ccfg.order_strategy)
    if len(records) < ccfg.batch_size:
        raise ValueError(f"train_contrastive needs at least batch_size={ccfg.batch_size} "
                         f"records for one batch; got {len(records)}")
    optimizer = make_optimizer(trained_parameters(model, tower), ccfg)

    # resume from the periodic snapshot; the data order restarts at epoch 0
    state_path = checkpoint_path + ".state" if checkpoint_path else None
    start_step = 0
    if state_path and os.path.exists(state_path):
        start_step = load_snapshot(state_path, model, tower, optimizer)
        print(f"[contrastive] resumed {state_path} at step {start_step}", flush=True)

    # the device-resident dataset, with the text of the whole corpus
    # tokenized once (the text tower may frame to another length than trg)
    dd = loader.device_dataset(dev)
    if dd is not None:
        tk, mk = clip_tokenize(loader._device_kept_smiles, ccfg.max_text_len)
        text_toks, text_mask = torch.from_numpy(tk).to(dev), torch.from_numpy(mk).to(dev)

    def epoch_batches(epoch: int):
        if dd is None:
            for batch in loader.epoch(epoch):
                toks, mask = clip_tokenize(_batch_smiles(batch), ccfg.max_text_len)
                yield (batch.inputs.to(dev), torch.from_numpy(toks).to(dev),
                       torch.from_numpy(mask).to(dev))
        else:
            for idx in loader.epoch_row_batches(epoch):
                ia = torch.from_numpy(idx).to(dev).long()
                yield dp.gather_rows(dd, ia).inputs, text_toks[ia], text_mask[ia]

    logger = MetricsLogger(metrics_path)
    loss_name = f"{tower}_loss"
    step_count = start_step
    done = bool(ccfg.max_steps and step_count >= ccfg.max_steps)  # resumed past the target
    try:
        for epoch in range(ccfg.num_epochs):
            if done:
                break
            for inputs, toks, mask in epoch_batches(epoch):
                loss = tower_step(model, optimizer, tower, _encode_frozen(mmt_model, inputs), toks,
                                  mask, ccfg.temperature, step_generator(seed, step_count))
                step_count += 1
                loss_host = float(loss)  # waits for the step, as the JAX loop does
                if step_count % ccfg.log_every == 0:
                    logger.log({"step": step_count, "epoch": epoch, loss_name: loss_host})
                if state_path and ccfg.save_every and step_count % ccfg.save_every == 0:
                    save_snapshot(state_path, model, tower, optimizer, step_count)
                if ccfg.max_steps and step_count >= ccfg.max_steps:
                    done = True
                    break
    except Exception:
        if checkpoint_path:
            export_tower(model, tower, checkpoint_path + ".backup.msgpack")
        raise
    finally:
        logger.close()
    if checkpoint_path:
        export_tower(model, tower, checkpoint_path)
    return model, logger


@torch.no_grad()
def retrieval_accuracy(
    model: nn.Module,
    mmt_cfg: MMTConfig,
    mmt_params: dict,
    records,
    tower: str = "blip",
    batch_size: int = 32,
    max_text_len: int = 64,
    seed: int = 0,
    device: DeviceLike = None,
) -> dict:
    """Contrastive retrieval over ``records``: R@1/R@5 of each SMILES
    retrieving its own spectrum among all N and the other way round, with the
    frozen bfloat16 encode of training, on ``device`` (cuda unless asked)."""
    dev = resolve_device(device)
    mmt_model = _encode_model(mmt_cfg.model, mmt_params, dev)
    records = _drop_truncating_records(records, mmt_cfg.model)
    loader = dp.Loader(records, mmt_cfg.model, batch_size, seed=seed, drop_remainder=False)
    was_training = model.training
    model.eval()
    text_embs, spec_embs = [], []
    try:
        for batch in loader.epoch(0):
            fp, memory, kpm = _encode_frozen(mmt_model, batch.inputs.to(dev))
            toks, mask = (torch.from_numpy(x).to(dev)
                          for x in clip_tokenize(_batch_smiles(batch), max_text_len))
            text, spec = (model(toks, mask, fp) if tower == "clip"
                          else model(toks, mask, memory, kpm))
            text_embs.append(text.float().cpu().numpy())
            spec_embs.append(spec.float().cpu().numpy())
    finally:
        model.train(was_training)
    text = np.concatenate(text_embs)
    spec = np.concatenate(spec_embs)
    text = text / np.linalg.norm(text, axis=1, keepdims=True)
    spec = spec / np.linalg.norm(spec, axis=1, keepdims=True)
    sim = text @ spec.T
    n = len(sim)
    gold = np.arange(n)

    def recall_at(k, s):
        rank = np.argsort(-s, axis=1)
        return float(np.mean([(gold[i] in rank[i, :k]) for i in range(n)]))

    return {"n": n,
            "text_to_spec_r1": recall_at(1, sim), "text_to_spec_r5": recall_at(5, sim),
            "spec_to_text_r1": recall_at(1, sim.T), "spec_to_text_r5": recall_at(5, sim.T)}
