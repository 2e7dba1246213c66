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

``to_jax_params`` is the inverse of ``from_jax_params``, and ``write_msgpack``
writes a tree in flax's msgpack encoding (bf16 leaves included), so the port's
parameters load in the JAX package's ``import_params_msgpack``.

``from_torch_state_dict`` / ``to_torch_state_dict`` map the reference's own
PyTorch checkpoints (212 MF rows) to and from the port's state dict, and
``load_torch_checkpoint`` reads a ``.pth`` or a Lightning ``.ckpt``;
``linear_tree`` is the inverse of ``linear_params`` for the GNN simulators.

``from_jax_clip_params`` does the same for the CLIP ranking tower
(``rank/clip.py``), whose bundle ``weights/clip_r4.msgpack.gz`` holds float32
leaves under a top-level ``params`` key, and ``from_jax_blip_params`` for the
BLIP tower (``rank/qformer.py``); ``to_jax_clip_params`` and
``to_jax_blip_params`` are their inverses, with keys sorted as the JAX
package's files have them.
"""

from __future__ import annotations

import gzip
import os
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
# msgpack encoding, as msgpack-python packs flax.serialization.to_bytes
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: tuple, codes: tuple) -> None:
    """A length header: the fix form (``fix`` = (base, max)) or the smallest of
    the 8/16/32-bit forms whose codes ``codes`` gives (None where a width has
    no form)."""
    base, fix_max = fix
    if fix_max is not None and n <= fix_max:
        out.append(base | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -(2**63))):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too small for msgpack")


def _array_payload(x) -> bytes:
    """flax's ndarray ext payload: msgpack (shape, dtype name, C bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name, raw = tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        else:
            x = x.numpy()
    if isinstance(x, np.ndarray):
        shape, name, raw = x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()
    return _packb([list(shape), name, raw])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), (0, None), (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), (0x90, 15), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, Mapping):
        _pack_len(out, len(obj), (0x80, 15), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor, np.generic)):
        code = _EXT_NPSCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        data = _array_payload(np.asarray(obj) if isinstance(obj, np.generic) else obj)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixext:
            out.append(fixext[len(data)])
        else:
            _pack_len(out, len(data), (0, None), (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += data
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def _packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def write_msgpack(tree: Mapping[str, Any], path: str) -> None:
    """Write a nested dict of arrays (numpy, or torch tensors, bfloat16
    included) as ``flax.serialization.to_bytes`` encodes it, byte for byte;
    ``.gz`` gzips the stream (level 6, as the JAX package's export does).
    The file is written to a per-process temporary name and then moved into
    place."""
    data = _packb(tree)
    tmp = f"{path}.tmp{os.getpid()}"
    if path.endswith(".gz"):
        with gzip.open(tmp, "wb", compresslevel=6) as f:
            f.write(data)
    else:
        with open(tmp, "wb") as f:
            f.write(data)
    os.replace(tmp, path)


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


# ---------------------------------------------------------------------------
# port state dict -> JAX parameter tree
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _dense_tree(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(), "bias": _np(sd[f"{prefix}.bias"])}


def _mha_tree(sd: Mapping, prefix: str) -> dict:
    return {"in_proj_weight": _np(sd[f"{prefix}.in_proj_weight"]),
            "in_proj_bias": _np(sd[f"{prefix}.in_proj_bias"]),
            "out_proj_weight": _np(sd[f"{prefix}.out_proj.weight"]),
            "out_proj_bias": _np(sd[f"{prefix}.out_proj.bias"])}


def _norm_tree(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _encoder_layer_tree(sd: Mapping, prefix: str) -> dict:
    return {"self_attn": _mha_tree(sd, f"{prefix}.self_attn"),
            "norm1": _norm_tree(sd, f"{prefix}.norm1"),
            "linear1": _dense_tree(sd, f"{prefix}.linear1"),
            "linear2": _dense_tree(sd, f"{prefix}.linear2"),
            "norm2": _norm_tree(sd, f"{prefix}.norm2")}


def _n_layers(sd: Mapping, prefix: str) -> int:
    head = prefix + ".layers."
    return len({k[len(head):].split(".")[0] for k in sd if k.startswith(head)})


def _stack(trees: list) -> Any:
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def to_jax_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's MMT state dict -> the JAX package's parameter tree (nested
    dicts of float32 numpy arrays; the five modality encoders stacked on a
    leading axis). The inverse of ``from_jax_params``."""
    tree: dict = {ours: _dense_tree(sd, theirs) for ours, theirs in SPEC_EMBED_TORCH_KEYS.items()}
    tree["embed_mf"] = {"embedding": _np(sd["linear_embedding_MF.embedding.weight"])}
    tree["embed_ms"] = {"embedding": _np(sd["linear_embedding_MS.embedding.weight"])}
    tree["embed_trg"] = {"embedding": _np(sd["embed_trg.weight"])}
    tree["pe_trg"] = {"embedding": _np(sd["pe_trg.weight"])}
    n_enc = _n_layers(sd, ENCODER_TORCH_PREFIXES[0])
    tree["modality_encoders"] = {
        f"layers_{i}": _stack([_encoder_layer_tree(sd, f"{p}.layers.{i}")
                               for p in ENCODER_TORCH_PREFIXES])
        for i in range(n_enc)
    }
    tree["encoder_cross"] = {f"layers_{i}": _encoder_layer_tree(sd, f"encoder_cross.layers.{i}")
                             for i in range(_n_layers(sd, "encoder_cross"))}
    decoder = {}
    for i in range(_n_layers(sd, "decoder")):
        prefix = f"decoder.layers.{i}"
        decoder[f"layers_{i}"] = {
            "self_attn": _mha_tree(sd, f"{prefix}.self_attn"),
            "norm1": _norm_tree(sd, f"{prefix}.norm1"),
            "multihead_attn": _mha_tree(sd, f"{prefix}.multihead_attn"),
            "norm2": _norm_tree(sd, f"{prefix}.norm2"),
            "linear1": _dense_tree(sd, f"{prefix}.linear1"),
            "linear2": _dense_tree(sd, f"{prefix}.linear2"),
            "norm3": _norm_tree(sd, f"{prefix}.norm3"),
        }
    tree["decoder"] = decoder
    for k in ("fp1", "fc_out", "real_data_linear"):
        tree[k] = _dense_tree(sd, k)
    return tree


def jax_paths(sd: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """Each key of the port's MMT state dict -> the ``/``-joined path of the
    JAX leaf it maps to (the five modality encoders share their stacked leaf,
    ``modality_encoders/layers_i/...``)."""
    paths: dict[str, str] = {}
    key_of = {}
    for ours, theirs in SPEC_EMBED_TORCH_KEYS.items():
        key_of[theirs] = ours
    fixed = {"linear_embedding_MF.embedding.weight": "embed_mf/embedding",
             "linear_embedding_MS.embedding.weight": "embed_ms/embedding",
             "embed_trg.weight": "embed_trg/embedding", "pe_trg.weight": "pe_trg/embedding"}
    leaf = {"weight": "kernel", "bias": "bias"}
    for k in sd:
        if k in fixed:
            paths[k] = fixed[k]
            continue
        parts = k.split(".")
        head = ".".join(parts[:-1])
        if head in key_of:
            paths[k] = f"{key_of[head]}/{leaf[parts[-1]]}"
            continue
        top = parts[0]
        if top in ENCODER_TORCH_PREFIXES or top in ("encoder_cross", "decoder"):
            root = "modality_encoders" if top in ENCODER_TORCH_PREFIXES else top
            rest = parts[3:]  # after <top>.layers.<i>
            sub = rest[0]
            if sub in ("self_attn", "multihead_attn"):
                name = "_".join(rest[1:]) if rest[1] == "out_proj" else rest[1]
            elif sub.startswith("norm"):
                name = {"weight": "scale", "bias": "bias"}[rest[1]]
            else:
                name = leaf[rest[1]]
            paths[k] = f"{root}/layers_{parts[2]}/{sub}/{name}"
            continue
        paths[k] = f"{top}/{leaf[parts[-1]]}"
    return paths


def _roberta_sd(sd: dict, prefix: str, te: Mapping) -> None:
    """A JAX ``RobertaStyleEncoder`` subtree -> port keys under ``prefix``."""
    sd[f"{prefix}.word_embeddings.weight"] = _t(te["word_embeddings"]["embedding"])
    sd[f"{prefix}.position_embeddings.weight"] = _t(te["position_embeddings"]["embedding"])
    sd[f"{prefix}.token_type_embedding"] = _t(te["token_type_embedding"])
    _norm(sd, f"{prefix}.emb_norm", te["emb_norm"])
    for name, layer in te["encoder"].items():
        _encoder_layer(sd, f"{prefix}.encoder.layers.{int(name.removeprefix('layers_'))}", layer)
    _linear(sd, f"{prefix}.pooler", te["pooler"])


def _head_sd(sd: dict, prefix: str, p: Mapping) -> None:
    _linear(sd, f"{prefix}.projection", p["projection"])
    _linear(sd, f"{prefix}.fc", p["fc"])
    _norm(sd, f"{prefix}.layer_norm", p["layer_norm"])


def from_jax_clip_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ``CLIPRanker`` variables (``{"params": ...}``, as a
    CLIP bundle and flax's ``init`` hold them) -> the float32 state dict of
    the port's ``rank.clip.CLIPRanker``. The text tower's
    ``token_type_embedding`` is one [hidden] vector, kept as such."""
    tree = tree["params"]
    sd: dict[str, torch.Tensor] = {}
    _roberta_sd(sd, "text_encoder", tree["text_encoder"])
    _linear(sd, "LL1", tree["LL1"])
    for head in ("CB_projection", "MT_projection"):
        _head_sd(sd, head, tree[head])
    return sd


def _sorted(tree: Any) -> Any:
    """Every dict of ``tree`` with its keys in sorted order: the order of a
    tree that came out of a jitted JAX function, and so of the files the JAX
    package writes."""
    if isinstance(tree, Mapping):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _roberta_tree(sd: Mapping, prefix: str) -> dict:
    return {
        "word_embeddings": {"embedding": _np(sd[f"{prefix}.word_embeddings.weight"])},
        "position_embeddings": {"embedding": _np(sd[f"{prefix}.position_embeddings.weight"])},
        "token_type_embedding": _np(sd[f"{prefix}.token_type_embedding"]),
        "emb_norm": _norm_tree(sd, f"{prefix}.emb_norm"),
        "encoder": {f"layers_{i}": _encoder_layer_tree(sd, f"{prefix}.encoder.layers.{i}")
                    for i in range(_n_layers(sd, f"{prefix}.encoder"))},
        "pooler": _dense_tree(sd, f"{prefix}.pooler"),
    }


def _head_tree(sd: Mapping, prefix: str) -> dict:
    return {"projection": _dense_tree(sd, f"{prefix}.projection"),
            "fc": _dense_tree(sd, f"{prefix}.fc"),
            "layer_norm": _norm_tree(sd, f"{prefix}.layer_norm")}


def to_jax_clip_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``CLIPRanker`` state dict -> the JAX package's variables
    ``{"params": ...}`` (float32 numpy leaves, keys sorted as in the JAX
    package's files). The inverse of ``from_jax_clip_params``."""
    params = {"text_encoder": _roberta_tree(sd, "text_encoder"), "LL1": _dense_tree(sd, "LL1"),
              "CB_projection": _head_tree(sd, "CB_projection"),
              "MT_projection": _head_tree(sd, "MT_projection")}
    return _sorted({"params": params})


# The Q-Former's optional leaves: present in a JAX tree only where a mode that
# reads them ran at init (text rows, the ITM and LM heads).
_QFORMER_LAYER_PARTS = {"self_attn": _mha, "cross_attn": _mha, "norm1": _norm, "norm_cross": _norm,
                        "linear1": _linear, "linear2": _linear, "norm2": _norm,
                        "linear1_text": _linear, "linear2_text": _linear, "norm2_text": _norm}


def qformer_params(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX ``QFormer`` parameter subtree (whole, or the partial overlay of
    ``from_hf_bert``) -> the port's ``rank.qformer.QFormer`` keys, each under
    ``prefix``; only the leaves present are converted."""
    sd: dict[str, torch.Tensor] = {}
    if "query_tokens" in tree:
        sd[f"{prefix}query_tokens"] = _t(tree["query_tokens"])
    if "text_embeddings" in tree:
        te = tree["text_embeddings"]
        sd[f"{prefix}text_embeddings.word_embeddings.weight"] = _t(
            te["word_embeddings"]["embedding"])
        sd[f"{prefix}text_embeddings.position_embeddings"] = _t(te["position_embeddings"])
        _norm(sd, f"{prefix}text_embeddings.norm", te["norm"])
    for name, layer in tree.items():
        if name.startswith("layers_"):
            lp = f"{prefix}layers.{int(name.removeprefix('layers_'))}"
            for part, p in layer.items():
                _QFORMER_LAYER_PARTS[part](sd, f"{lp}.{part}", p)
    return sd


def from_jax_blip_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's ``BLIPRanker`` variables (``{"params": ...}``) -> the
    float32 state dict of the port's ``rank.qformer.BLIPRanker``, with the
    leaves the tree holds: a tree from ``init`` of the contrastive towers
    alone lacks the Q-Former's text rows and the ITM and LM heads."""
    tree = tree["params"]
    sd = qformer_params(tree["qformer"], "qformer.")
    _linear(sd, "mmt_proj", tree["mmt_proj"])
    _roberta_sd(sd, "text_encoder", tree["text_encoder"])
    _head_sd(sd, "spec_projection", tree["spec_projection"])
    _head_sd(sd, "text_projection", tree["text_projection"])
    if "itm_head" in tree:
        _linear(sd, "itm_head", tree["itm_head"])
    if "lm_head" in tree:
        lm = tree["lm_head"]
        _linear(sd, "lm_head.transform", lm["transform"])
        _norm(sd, "lm_head.transform_norm", lm["transform_norm"])
        sd["lm_head.bias"] = _t(lm["bias"])
    return sd


def to_jax_blip_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``BLIPRanker`` state dict (whole, or without the optional
    leaves) -> the JAX package's variables ``{"params": ...}``, keys sorted.
    The inverse of ``from_jax_blip_params``."""
    parts = {"self_attn": _mha_tree, "cross_attn": _mha_tree, "norm1": _norm_tree,
             "norm_cross": _norm_tree, "linear1": _dense_tree, "linear2": _dense_tree,
             "norm2": _norm_tree, "linear1_text": _dense_tree, "linear2_text": _dense_tree,
             "norm2_text": _norm_tree}
    qf: dict = {"query_tokens": _np(sd["qformer.query_tokens"])}
    if "qformer.text_embeddings.position_embeddings" in sd:
        qf["text_embeddings"] = {
            "word_embeddings": {"embedding": _np(sd["qformer.text_embeddings.word_embeddings.weight"])},
            "position_embeddings": _np(sd["qformer.text_embeddings.position_embeddings"]),
            "norm": _norm_tree(sd, "qformer.text_embeddings.norm"),
        }
    for i in range(_n_layers(sd, "qformer")):
        lp = f"qformer.layers.{i}"
        qf[f"layers_{i}"] = {part: fn(sd, f"{lp}.{part}") for part, fn in parts.items()
                             if any(k.startswith(f"{lp}.{part}.") for k in sd)}
    params = {"mmt_proj": _dense_tree(sd, "mmt_proj"), "qformer": qf,
              "text_encoder": _roberta_tree(sd, "text_encoder"),
              "spec_projection": _head_tree(sd, "spec_projection"),
              "text_projection": _head_tree(sd, "text_projection")}
    if "itm_head.weight" in sd:
        params["itm_head"] = _dense_tree(sd, "itm_head")
    if "lm_head.bias" in sd:
        params["lm_head"] = {"transform": _dense_tree(sd, "lm_head.transform"),
                             "transform_norm": _norm_tree(sd, "lm_head.transform_norm"),
                             "bias": _np(sd["lm_head.bias"])}
    return _sorted({"params": params})


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


def linear_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``linear_params``: torch Linear keys -> a flax tree of
    float32 numpy ``kernel`` [in, out] / ``bias`` leaves, keys sorted as a
    jitted JAX function returns them."""
    tree: dict = {}
    for k, v in sd.items():
        *path, leaf = k.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        arr = _np(v)
        node["kernel" if leaf == "weight" else leaf] = arr.T.copy() if leaf == "weight" else arr
    return _sorted(tree)


# ---------------------------------------------------------------------------
# the reference's PyTorch checkpoints
# ---------------------------------------------------------------------------

MF_KEY = "linear_embedding_MF.embedding.weight"


def _model_keys(cfg) -> list[str]:
    """The state-dict keys of ``MultimodalTransformer(cfg)``, built on the
    meta device (no storage)."""
    from .mmt import MultimodalTransformer

    with torch.device("meta"):
        return list(MultimodalTransformer(cfg).state_dict())


def from_torch_state_dict(cfg, sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference ``MultimodalTransformer`` state dict (torch tensors or
    numpy arrays) -> the port's float32 state dict for ``cfg``. The keys are
    the same; the MF table's 212 rows gain the zero 213th row the port's
    table holds. Keys the model does not have are ignored."""
    out = {k: _t(sd[k]) for k in _model_keys(cfg) if k != MF_KEY}
    mf = _t(sd[MF_KEY])
    out[MF_KEY] = torch.cat([mf, mf.new_zeros(1, mf.shape[1])])
    return out


def to_torch_state_dict(cfg, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's state dict for ``cfg`` -> the reference's (float32 CPU
    tensors; the MF table without its 213th row)."""
    out = {k: _t(sd[k]) for k in _model_keys(cfg)}
    out[MF_KEY] = out[MF_KEY][:-1].contiguous()
    return out


def load_torch_checkpoint(cfg, path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` (a raw state dict) or Lightning ``.ckpt`` (the
    weights under ``state_dict`` with a ``model.`` prefix) -> the port's
    state dict for ``cfg``. The file is unpickled in full: load only
    checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = {k.removeprefix("model."): v for k, v in blob["state_dict"].items()}
    return from_torch_state_dict(cfg, blob)
