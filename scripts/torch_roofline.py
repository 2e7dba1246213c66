#!/usr/bin/env python3
"""Utilization accounting for the headline numbers on one NVIDIA H100.

States what share of the card's own peaks a measured train step and a
measured MNS fan-out decode round reach, so a throughput figure can be
checked against the hardware. The counterpart of ``scripts/roofline.py``,
with the same analytic counts: FLOPs from ``ModelConfig`` (2 FLOPs per
multiply-add), and a bandwidth model that charges each stage its parameter
bytes, KV-cache traffic and activation traffic at the compute dtype. The
shares are against the H100 peaks of
``multimodalspectraltransformer_torch/utils/roofline.py`` (989 TFLOP/s bf16,
3.35 TB/s HBM3, at the full 700 W power limit; state the card's limit from
nvidia-smi beside any share).

The times are required: they must be measured on the card, for example by
``scripts/torch_roofline_report.py`` (the train step's ``wall_s``) or
``bench_torch.py``:

  python3 scripts/torch_roofline.py --train-ms T --decode-ms D [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.utils.config import ModelConfig
from multimodalspectraltransformer_torch.utils.roofline import H100_HBM_BYTES_PER_S, H100_PEAK_FLOPS

BF16_PEAK = H100_PEAK_FLOPS["bfloat16"]  # FLOP/s
HBM_BW = H100_HBM_BYTES_PER_S  # bytes/s


def encoder_layer_flops(S: int, d: int, f: int) -> float:
    """One post-norm transformer encoder layer, fwd: QKV+out projections,
    scores+apply, two FFN matmuls. 2 FLOPs/MAC."""
    proj = 8 * S * d * d
    attn = 4 * S * S * d
    ffn = 4 * S * d * f
    return float(proj + attn + ffn)


def decoder_layer_flops(T: int, S_mem: int, d: int, f: int,
                        include_cross_kv: bool = True) -> float:
    """One decoder layer, fwd, full-sequence (training) shape: self-attn over
    T, cross-attn over S_mem, FFN. Cross K/V projection of the memory is
    charged once per layer (shared across beam/fan-out lanes at inference:
    pass include_cross_kv=False there and charge it separately)."""
    self_proj = 8 * T * d * d
    self_attn = 4 * T * T * d
    cross_q_out = 4 * T * d * d
    cross_kv = 4 * S_mem * d * d if include_cross_kv else 0
    cross_attn = 4 * T * S_mem * d
    ffn = 4 * T * d * f
    return float(self_proj + self_attn + cross_q_out + cross_kv + cross_attn + ffn)


def model_shapes(cfg: ModelConfig):
    nmr = cfg.nmr_seq_len  # 129 default
    ir = cfg.ir_seq_len  # 66
    fused = 4 * nmr + ir  # 582 (all modalities on, no parity blank)
    return nmr, ir, fused


def forward_flops_per_sample(cfg: ModelConfig, T: int = 63) -> float:
    d, f = cfg.hidden_size, cfg.ffn_dim
    nmr, ir, fused = model_shapes(cfg)
    enc = cfg.num_encoder_layers * (
        4 * encoder_layer_flops(nmr, d, f) + encoder_layer_flops(ir, d, f)
    )
    fusion = cfg.num_encoder_layers * encoder_layer_flops(fused, d, f)
    dec = cfg.num_decoder_layers * decoder_layer_flops(T, fused, d, f)
    head = 2 * T * d * cfg.smiles_vocab_size + 2 * d * cfg.fingerprint_size
    return enc + fusion + dec + head


def param_count(cfg: ModelConfig) -> float:
    d, f = cfg.hidden_size, cfg.ffn_dim
    enc_layer = 4 * d * d + 2 * d * f + 4 * d  # attn + ffn (+ LN, biases approx)
    dec_layer = 4 * d * d + 4 * d * d + 2 * d * f + 6 * d  # self + cross + ffn
    n_enc = 5 * cfg.num_encoder_layers + cfg.num_encoder_layers  # modality + fusion
    return float(n_enc * enc_layer + cfg.num_decoder_layers * dec_layer
                 + cfg.smiles_vocab_size * d + cfg.max_len * d
                 + d * cfg.fingerprint_size + cfg.ir_bins * d)


def decode_step_flops_per_lane(cfg: ModelConfig, t: int, S_mem: int) -> float:
    """One incremental token for one lane with a KV cache at length t:
    projections for the new token + attention against the cache + cross-attn
    against the (shared, precomputed) memory + FFN."""
    d, f = cfg.hidden_size, cfg.ffn_dim
    L = cfg.num_decoder_layers
    proj = 8 * d * d + 4 * d * d  # self QKV+out, cross Q+out
    self_attn = 4 * t * d
    cross_attn = 4 * S_mem * d
    ffn = 4 * d * f
    head = 2 * d * cfg.smiles_vocab_size
    return float(L * (proj + self_attn + cross_attn + ffn) + head)


def fmt(x: float) -> str:
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6)):
        if x >= div:
            return f"{x / div:.2f} {unit}"
    return f"{x:.0f} "


def _bound(flop_share: float, hbm_share: float) -> str:
    """Which modeled share of the card's peaks is the larger."""
    which = "the modeled HBM traffic" if hbm_share > flop_share else "the FLOP rate"
    return (f"the larger share of the H100's peaks is {which} "
            f"({flop_share * 100:.2f}% of bf16 FLOP/s, {hbm_share * 100:.2f}% of HBM bandwidth)")


def rows(train_ms: float, train_batch: int, decode_ms: float, decode_lanes: int,
         decode_mols: int, decode_len: int) -> dict:
    """The ``--json`` rows: ``scripts/roofline.py``'s counts, shared against
    the H100's peaks."""
    cfg = ModelConfig(dtype="bfloat16")
    bytes_per = 2  # bf16

    # ---- train step: fwd + bwd ~= 3x fwd FLOPs -----------------------------
    fwd = forward_flops_per_sample(cfg)
    train_flops = 3 * fwd * train_batch
    train_achieved = train_flops / (train_ms / 1e3)
    train_mfu = train_achieved / BF16_PEAK
    params = param_count(cfg)
    # bandwidth: params read fwd + read bwd + grads written + optimizer state
    # touched (m, v read+write, params written) ~= 8x param bytes, fp32 opt
    train_bytes = params * (2 * bytes_per + 6 * 4)
    train_bw = train_bytes / (train_ms / 1e3)

    # ---- MNS decode round: decode-len incremental steps over all lanes ----
    nmr, ir, fused = model_shapes(cfg)
    per_tok = sum(
        decode_step_flops_per_lane(cfg, t, fused) for t in range(decode_len)
    ) / decode_len
    dec_flops = per_tok * decode_len * decode_lanes
    dec_achieved = dec_flops / (decode_ms / 1e3)
    dec_mfu = dec_achieved / BF16_PEAK
    # bandwidth: per token step, every lane re-reads its merged KV cache
    # [H, 2Dh, T] plus the decoder weights once per step (amortized over
    # lanes) plus the shared cross-KV memory once per step
    d = cfg.hidden_size
    L = cfg.num_decoder_layers
    kv_bytes_per_lane_tok = L * 2 * d * (decode_len / 2) * bytes_per
    dec_params = L * (8 * d * d + 2 * d * cfg.ffn_dim)
    total_bytes = decode_len * (
        decode_lanes * kv_bytes_per_lane_tok  # every step re-reads each cache
        + dec_params * bytes_per  # weights, amortized over lanes per step
        + decode_mols * fused * 2 * d * bytes_per  # shared cross-KV memory
    )
    dec_bw = total_bytes / (decode_ms / 1e3)

    return {
        "model_params": params,
        "train_step": {
            "batch": train_batch, "ms": train_ms,
            "flops": train_flops, "achieved_flops_per_s": train_achieved,
            "mfu_vs_bf16_peak": train_mfu,
            "hbm_bytes_modeled": train_bytes,
            "hbm_gbps_modeled": train_bw / 1e9,
            "bound": _bound(train_mfu, train_bw / HBM_BW),
        },
        "mns_decode_round": {
            "lanes": decode_lanes, "ms": decode_ms,
            "flops": dec_flops, "achieved_flops_per_s": dec_achieved,
            "mfu_vs_bf16_peak": dec_mfu,
            "hbm_gbps_modeled": dec_bw / 1e9,
            "hbm_util_modeled": dec_bw / HBM_BW,
            "bound": _bound(dec_mfu, dec_bw / HBM_BW),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-ms", type=float, required=True,
                    help="train_step wall ms measured on the card (batch --train-batch, bf16)")
    ap.add_argument("--train-batch", type=int, default=64)
    ap.add_argument("--decode-ms", type=float, required=True,
                    help="MNS fan-out round ms measured on the card (--decode-lanes lanes)")
    ap.add_argument("--decode-lanes", type=int, default=24 * 128)
    ap.add_argument("--decode-mols", type=int, default=24)
    ap.add_argument("--decode-len", type=int, default=128)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    out = rows(args.train_ms, args.train_batch, args.decode_ms, args.decode_lanes,
               args.decode_mols, args.decode_len)
    if args.json:
        print(json.dumps(out))
        return 0
    params = out["model_params"]
    print(f"model params (analytic): {fmt(params)} ({fmt(params * 2)}B bf16)")
    t = out["train_step"]
    print(f"\ntrain_step B={t['batch']} @ {t['ms']:g} ms:")
    print(f"  {fmt(t['flops'])}FLOP -> {fmt(t['achieved_flops_per_s'])}FLOP/s "
          f"= {t['mfu_vs_bf16_peak'] * 100:.2f}% of the H100 bf16 peak")
    print(f"  modeled HBM traffic {t['hbm_gbps_modeled']:.1f} GB/s "
          f"({t['hbm_gbps_modeled'] / (HBM_BW / 1e9) * 100:.2f}% of peak)")
    print(f"  {t['bound']}")
    m = out["mns_decode_round"]
    print(f"\nMNS decode round, {m['lanes']} lanes @ {m['ms']:g} ms:")
    print(f"  {fmt(m['flops'])}FLOP -> {fmt(m['achieved_flops_per_s'])}FLOP/s "
          f"= {m['mfu_vs_bf16_peak'] * 100:.2f}% of the H100 bf16 peak")
    print(f"  modeled HBM traffic {m['hbm_gbps_modeled']:.1f} GB/s "
          f"({m['hbm_util_modeled'] * 100:.2f}% of peak)")
    print(f"  {m['bound']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
