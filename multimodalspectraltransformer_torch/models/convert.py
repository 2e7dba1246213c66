"""Checkpoint bridge: flax msgpack files -> the port's state dict.

The JAX package writes its parameters with ``flax.serialization.to_bytes``
(optionally gzipped, often with bf16-stored leaves). This module reads those
files with the standard library alone (``read_msgpack``) and renames the
parameter tree into the port's state dict (``from_jax_params``), which uses
the reference torch model's keys:

- Linear kernels [in, out] are transposed to torch ``weight`` [out, in],
- attention tensors keep their torch layout (``in_proj_weight`` etc.),
- the five modality encoders, stacked on a leading axis in the JAX tree
  (order 1H, 13C, HSQC, COSY, IR), are split into ``encoder_1H`` ...
  ``encoder_IR``,
- the MF embedding keeps all 213 rows (the 213th row exists because the
  reference vocabulary can emit id 212).

``from_jax_clip_params`` does the same for the CLIP ranking tower
(``rank/clip.py``), whose bundle ``weights/clip_r4.msgpack.gz`` holds float32
leaves under a top-level ``params`` key.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any, Mapping

import numpy as np
import torch

SPEC_EMBED_TORCH_KEYS = {
    "embed_1h": "linear_spec_embedding_1H.point_embedding_layer_1H.fc_H",
    "embed_13c": "linear_spec_embedding_13C.point_embedding_layer_13C.fc_C",
    "embed_hsqc": "linear_spec_embedding_HSQC.point_embedding_layer_HSQC.fc_HSQC",
    "embed_cosy": "linear_spec_embedding_COSY.point_embedding_layer_COSY.fc_COSY",
    "embed_ir": "linear_spec_embedding_IR.linear_spec_embedding_IR",
    "embed_mw": "linear_embedding_MW.linear_spec_embedding_MW",
}

ENCODER_TORCH_PREFIXES = ("encoder_1H", "encoder_13C", "encoder_HSQC", "encoder_COSY", "encoder_IR")

# flax.serialization ext type codes
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# msgpack decoding (https://github.com/msgpack/msgpack/blob/master/spec.md)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack stream")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.unpack((">B", ">H", ">I")[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.obj() for _ in range(self.unpack((">H", ">I")[b - 0xDC]))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack((">H", ">I")[b - 0xDE]))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(1 << (b - 0xD4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ext(code: int, data: bytes):
    """flax's ndarray ext payload: msgpack (shape, dtype name, raw C bytes)."""
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    r = _Reader(data)
    shape, name, raw = r.obj()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        # numpy has no bfloat16: keep the bits, reinterpret in torch
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        arr = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
    if code == _EXT_NPSCALAR:
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    return arr


def read_msgpack(path: str) -> dict:
    """Decode a flax msgpack file (``.gz`` is gunzipped) into a nested dict
    of numpy arrays; bfloat16 leaves come back as torch bfloat16 tensors."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: top-level object is not a map")
    return tree


# ---------------------------------------------------------------------------
# JAX parameter tree -> port state dict
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    """Any leaf (numpy, torch, jax array) -> float32 torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _mha(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.in_proj_weight"] = _t(p["in_proj_weight"])
    sd[f"{prefix}.in_proj_bias"] = _t(p["in_proj_bias"])
    sd[f"{prefix}.out_proj.weight"] = _t(p["out_proj_weight"])
    sd[f"{prefix}.out_proj.bias"] = _t(p["out_proj_bias"])


def _norm(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _encoder_layer(sd: dict, prefix: str, p: Mapping) -> None:
    _mha(sd, f"{prefix}.self_attn", p["self_attn"])
    _linear(sd, f"{prefix}.linear1", p["linear1"])
    _linear(sd, f"{prefix}.linear2", p["linear2"])
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])


def _index(tree: Any, m: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _index(v, m) for k, v in tree.items()}
    return tree[m]


def from_jax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's MMT parameters (nested dicts of arrays, as
    ``read_msgpack`` or ``flax`` returns them) -> the port's float32 state
    dict. The one function that carries MMT weights across."""
    sd: dict[str, torch.Tensor] = {}
    for ours, theirs in SPEC_EMBED_TORCH_KEYS.items():
        _linear(sd, theirs, tree[ours])
    sd["linear_embedding_MF.embedding.weight"] = _t(tree["embed_mf"]["embedding"])
    sd["linear_embedding_MS.embedding.weight"] = _t(tree["embed_ms"]["embedding"])
    sd["embed_trg.weight"] = _t(tree["embed_trg"]["embedding"])
    sd["pe_trg.weight"] = _t(tree["pe_trg"]["embedding"])

    enc = tree["modality_encoders"]
    for name, layer in enc.items():
        i = int(name.removeprefix("layers_"))
        for m, prefix in enumerate(ENCODER_TORCH_PREFIXES):
            _encoder_layer(sd, f"{prefix}.layers.{i}", _index(layer, m))
    for name, layer in tree["encoder_cross"].items():
        _encoder_layer(sd, f"encoder_cross.layers.{int(name.removeprefix('layers_'))}", layer)
    for name, p in tree["decoder"].items():
        prefix = f"decoder.layers.{int(name.removeprefix('layers_'))}"
        _mha(sd, f"{prefix}.self_attn", p["self_attn"])
        _mha(sd, f"{prefix}.multihead_attn", p["multihead_attn"])
        _linear(sd, f"{prefix}.linear1", p["linear1"])
        _linear(sd, f"{prefix}.linear2", p["linear2"])
        for k in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{prefix}.{k}", p[k])
    for k in ("fp1", "fc_out", "real_data_linear"):
        _linear(sd, k, tree[k])
    return sd


def from_jax_clip_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ``CLIPRanker`` variables (``{"params": ...}``, as a
    CLIP bundle and flax's ``init`` hold them) -> the float32 state dict of
    the port's ``rank.clip.CLIPRanker``. The text tower's
    ``token_type_embedding`` is one [hidden] vector, kept as such."""
    tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}
    te = tree["text_encoder"]
    sd["text_encoder.word_embeddings.weight"] = _t(te["word_embeddings"]["embedding"])
    sd["text_encoder.position_embeddings.weight"] = _t(te["position_embeddings"]["embedding"])
    sd["text_encoder.token_type_embedding"] = _t(te["token_type_embedding"])
    _norm(sd, "text_encoder.emb_norm", te["emb_norm"])
    for name, layer in te["encoder"].items():
        _encoder_layer(sd, f"text_encoder.encoder.layers.{int(name.removeprefix('layers_'))}", layer)
    _linear(sd, "text_encoder.pooler", te["pooler"])
    _linear(sd, "LL1", tree["LL1"])
    for head in ("CB_projection", "MT_projection"):
        _linear(sd, f"{head}.projection", tree[head]["projection"])
        _linear(sd, f"{head}.fc", tree[head]["fc"])
        _norm(sd, f"{head}.layer_norm", tree[head]["layer_norm"])
    return sd


def linear_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax tree of Dense layers -> torch Linear keys (``a.b.weight`` with
    the kernel transposed, ``a.b.bias``), for the GNN simulators."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        if "kernel" in node:
            sd[f"{prefix}weight"] = _t(node["kernel"]).T.contiguous()
            if "bias" in node:
                sd[f"{prefix}bias"] = _t(node["bias"])
            return
        for k, v in node.items():
            walk(v, f"{prefix}{k}.")

    walk(tree, "")
    return sd
