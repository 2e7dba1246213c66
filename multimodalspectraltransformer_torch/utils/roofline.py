"""Roofline and utilization accounting on one NVIDIA H100.

Counterpart of the JAX package's ``utils/roofline.py``: turns (work, wall
time) into achieved FLOP/s and device-memory bytes/s against the card's
published peaks, and names the bound resource. FLOP counts come from
``torch.utils.flop_counter.FlopCounterMode`` (``flop_count``; matrix
products, forward and backward) or analytically from the parameter shapes
(``decode_step_cost``); memory traffic is analytic.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s HBM3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch

H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12


@dataclass
class Roofline:
    name: str
    wall_s: float
    flops: float
    hbm_bytes: float
    dtype: str = "bfloat16"

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.wall_s

    @property
    def achieved_bw(self) -> float:
        return self.hbm_bytes / self.wall_s

    @property
    def mfu(self) -> float:
        return self.achieved_flops / H100_PEAK_FLOPS[self.dtype]

    @property
    def hbm_util(self) -> float:
        return self.achieved_bw / H100_HBM_BYTES_PER_S

    @property
    def bound(self) -> str:
        return "HBM-bandwidth" if self.hbm_util > self.mfu else "compute"

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "wall_s": round(self.wall_s, 5),
            "achieved_tflops": round(self.achieved_flops / 1e12, 3),
            "mfu": round(self.mfu, 4),
            "achieved_hbm_gbps": round(self.achieved_bw / 1e9, 2),
            "hbm_utilization": round(self.hbm_util, 4),
            "bound": self.bound,
        }

    def sentence(self) -> str:
        return (
            f"{self.name}: {self.achieved_flops / 1e12:.2f} TFLOP/s "
            f"({self.mfu * 100:.1f}% of the {self.dtype} peak), {self.achieved_bw / 1e9:.0f} GB/s "
            f"HBM ({self.hbm_util * 100:.0f}% of peak) -> {self.bound}-bound"
        )


def _param_matmul_flops_per_token(sd: Mapping[str, torch.Tensor], prefix: str) -> float:
    """2 * the sizes of the matrices under ``prefix``: the per-token
    multiply-adds of every dense projection on that path (attention dots
    and softmax excluded; callers add them)."""
    return 2.0 * sum(v.numel() for k, v in sd.items() if k.startswith(prefix) and v.dim() >= 2)


def _param_bytes(sd: Mapping[str, torch.Tensor], prefix: str, bytes_per: int) -> float:
    return float(sum(v.numel() for k, v in sd.items() if k.startswith(prefix)) * bytes_per)


def decode_step_cost(cfg, sd: Mapping[str, torch.Tensor], lanes: int, t_avg: float,
                     memory_s: int) -> dict:
    """FLOPs and memory bytes of ONE decode step over ``lanes`` KV-cached
    lanes at average cache length ``t_avg``, with cross-attention memory of
    length ``memory_s``, for the port's MMT state dict ``sd``.

    The per-token dense path is counted from the decoder's matrices;
    attention adds 2*2*D*t (self, against the cache) and 2*2*D*S (cross)
    multiply-adds per lane and token. Memory per step: the decoder weights
    once (bf16), the cache appended and read per lane, the logits written."""
    D = cfg.hidden_size
    L = cfg.num_decoder_layers
    dense = _param_matmul_flops_per_token(sd, "decoder.")
    dense += 2.0 * cfg.smiles_vocab_size * D * 2  # embedding + output head
    attn = 4.0 * D * t_avg * L + 4.0 * D * memory_s * L
    flops = lanes * (dense + attn)

    bytes_weights = _param_bytes(sd, "decoder.", 2)  # bf16 stream
    kv_read = lanes * L * 2 * (cfg.hidden_size // cfg.num_heads) * cfg.num_heads * t_avg * 2
    cross_read = lanes * L * 2 * D * memory_s * 2
    act = lanes * D * 8 * L * 2
    return {"flops": flops, "hbm_bytes": bytes_weights + kv_read + cross_read + act}


def flop_count(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn`` as ``FlopCounterMode`` counts them (matrix
    products, convolutions and attention, forward and backward; elementwise
    work is not counted). The call runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
