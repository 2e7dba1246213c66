"""The MMT's training loss.

Counterpart of the JAX package's ``train/loss.py``:

- SMILES cross-entropy over *all* positions: the reference uses
  ``torch.nn.CrossEntropyLoss()`` with no ``ignore_index``, so <PAD>
  positions count in the mean (``pad_aware`` averages over non-pad targets
  only);
- fingerprint BCE-with-logits against the Morgan target, in its stable form;
- ``total_loss``: their weighted sum plus host-computed scalar terms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import dp_sum
from ..parallel.mesh import RankShard
from ..utils import vocab


class LossOutput(NamedTuple):
    total: torch.Tensor
    smi_loss: torch.Tensor
    fp_loss: torch.Tensor


def smiles_cross_entropy(
    logits: torch.Tensor,  # [B, T, V]
    targets: torch.Tensor,  # [B, T] int ids
    mask: Optional[torch.Tensor] = None,  # [B, T] 1 = count this position
    shard: Optional[RankShard] = None,
) -> torch.Tensor:
    """The mean NLL (over ``mask``'s positions). Under ``shard`` the batch is
    this rank's rows: the masked mean divides by the global count, times the
    number of data-parallel ranks, so the mean over ranks of the values (and
    of their gradients) is the global batch's."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        # reference parity: a plain mean, padding included
        return nll.mean()
    mask = mask.to(nll.dtype)
    if shard is not None and shard.dp_size > 1:
        count = dp_sum(mask.sum(), shard)
        return (nll * mask).sum() * shard.dp_size / count.clamp_min(1.0)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def fingerprint_bce(fp_logits: torch.Tensor, fp_target: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss, mean reduction, as max(z, 0) - z y + log(1 + exp(-|z|))."""
    z = fp_logits
    y = fp_target.to(z.dtype)
    return (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def total_loss(
    logits: torch.Tensor,
    trg_tokens_full: torch.Tensor,  # [B, T+1] the <SOS>...<EOS> padded sequence
    fp_logits: torch.Tensor,
    fp_target: torch.Tensor,
    weight_smi: float = 1.0,
    weight_fp: float = 0.0,
    pad_aware: bool = False,
    extra: torch.Tensor | float = 0.0,  # host-computed scalar terms
    shard: Optional[RankShard] = None,
) -> LossOutput:
    """Teacher forcing: input trg[:, :-1], target trg[:, 1:]. Under ``shard``
    each term is the rank's share whose mean over the data-parallel ranks is
    the global batch's (``smiles_cross_entropy``)."""
    targets = trg_tokens_full[:, 1:]
    mask = (targets != vocab.PAD_ID) if pad_aware else None
    smi = smiles_cross_entropy(logits, targets, mask, shard)
    fp = fingerprint_bce(fp_logits, fp_target)
    total = weight_smi * smi + weight_fp * fp + extra
    return LossOutput(total, smi, fp)
