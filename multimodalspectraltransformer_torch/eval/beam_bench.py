"""Beam mode: the generation stage alone, at its worst case.

Counterpart of ``bench.py``'s ``BENCH_MODE=beam``: a batch of ``BATCH``
molecules with uniform random spectra (made from a numpy seed) and molecular
weights spread over 100-350, the full-width encoder over all five
modalities, then the ancestry beam search with beam ``BEAM`` over ``MAX_LEN``
steps without early exit, decoding in bfloat16. ``chip_smoke.py`` and
``scripts/torch_profile_main_path.py --beam`` drive it on the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..decode import samplers
from ..models.mmt import MMTBatch, MultimodalTransformer, dummy_batch
from ..utils.config import ModelConfig
from ..utils.device import DeviceLike

BATCH, BEAM, MAX_LEN = 128, 5, 128


def beam_mode_batch(cfg: ModelConfig, batch_size: int = BATCH, seed: int = 0,
                    device: DeviceLike = None) -> MMTBatch:
    """``dummy_batch`` with uniform [0, 1) spectra and linearly spread MWs."""
    batch = dummy_batch(cfg, batch_size, device)
    rng = np.random.default_rng(seed)

    def uniform(x: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(rng.random(tuple(x.shape), dtype=np.float32)).to(x.device)

    return batch._replace(
        src_1h=uniform(batch.src_1h), src_13c=uniform(batch.src_13c),
        src_hsqc=uniform(batch.src_hsqc), src_cosy=uniform(batch.src_cosy),
        src_ir=uniform(batch.src_ir),
        mw=torch.linspace(100.0, 350.0, batch_size, device=batch.mw.device),
    )


def run(model: MultimodalTransformer, batch: MMTBatch, beam_size: int = BEAM,
        max_len: int = MAX_LEN, compute_dtype: str = "bfloat16") -> tuple[dict, samplers.BeamResult]:
    """Encode ``batch`` and beam-decode every molecule for ``max_len`` steps.
    Returns host seconds per stage, "encode" (ending in a device sync) and
    "beam" (ending when the tokens reach the host), and the beams."""
    t0 = time.perf_counter()
    enc = model.encode(batch)
    if enc.memory.is_cuda:
        torch.cuda.synchronize(enc.memory.device)
    t1 = time.perf_counter()
    res = samplers.beam_search(
        model.state_dict(), model.cfg, enc.memory, enc.memory_key_padding_mask, beam_size, 1.0,
        max_len, early_exit=False, compute_dtype=compute_dtype, device=batch.mw.device,
    )
    res.tokens.cpu()
    t2 = time.perf_counter()
    return {"encode": t1 - t0, "beam": t2 - t1, "total": t2 - t0}, res
