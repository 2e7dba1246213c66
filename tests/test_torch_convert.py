"""The port's msgpack reader and weight bridge against msgpack + flax.

The reader must give, bit for bit, what ``import_params_msgpack`` (msgpack +
flax) and ``to_torch_state_dict`` give, without either package."""

from __future__ import annotations

import gzip
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_tpu.models import convert as jconvert
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.train import checkpoint
from multimodalspectraltransformer_tpu.utils.config import ModelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE3 = os.path.join(REPO, "weights", "mmt_r4_phase3.msgpack.gz")
SIM_WEIGHTS = os.path.join(REPO, "multimodalspectraltransformer_tpu", "sim", "weights")

_CACHE: dict = {}


def _phase3():
    if "p" not in _CACHE:
        cfg = ModelConfig()
        template = jmmt.init_params(cfg, jax.random.PRNGKey(0))
        params = checkpoint.import_params_msgpack(template, PHASE3)
        _CACHE["p"] = (cfg, params, tconvert.from_jax_params(tconvert.read_msgpack(PHASE3)))
    return _CACHE["p"]


def test_reader_matches_flax_on_phase3_bit_for_bit():
    cfg, params, sd = _phase3()
    ref = jconvert.to_torch_state_dict(cfg, params)
    # to_torch_state_dict drops the MF table's 213th row; the port keeps it
    mf = "linear_embedding_MF.embedding.weight"
    assert set(ref) == set(sd)
    for k, v in ref.items():
        ours = sd[k].numpy()
        if k == mf:
            assert ours.shape == (213, 128)
            np.testing.assert_array_equal(ours[212], np.asarray(params["embed_mf"]["embedding"])[212])
            ours = ours[:212]
        assert ours.dtype == np.float32 and ours.shape == v.shape, k
        np.testing.assert_array_equal(ours, np.asarray(v, np.float32), err_msg=k)


def test_reader_keeps_bfloat16_bits():
    """bf16 leaves come back as torch.bfloat16 with the stored bits."""
    tree = tconvert.read_msgpack(PHASE3)
    leaf = tree["decoder"]["layers_0"]["linear1"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    raw = msgpack.unpackb(gzip.open(PHASE3).read(), raw=False,
                          ext_hook=lambda c, d: msgpack.unpackb(d, raw=True))
    shape, name, buf = raw["decoder"]["layers_0"]["linear1"]["kernel"]
    assert name == b"bfloat16" and list(leaf.shape) == list(shape)
    assert leaf.view(torch.int16).numpy().tobytes() == buf


@pytest.mark.parametrize("name", ["nmr_shift.msgpack", "ir.msgpack"])
def test_reader_matches_flax_on_simulator_weights(name):
    path = os.path.join(SIM_WEIGHTS, name)
    ours = tconvert.read_msgpack(path)
    ref = serialization.msgpack_restore(open(path, "rb").read())
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert flat_ref
    for key_path, v in flat_ref:
        node = ours
        for k in key_path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(v))


VALUES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -128,
             -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)],
    "floats": [0.0, -1.5, 3.25e300],
    "strings": ["", "a", "x" * 31, "y" * 32, "z" * 300, "é" * 40000],
    "bytes": [b"", b"\x00\xff", b"q" * 300, b"r" * 70000],
    "containers": [[], [1, [2, [3]]], list(range(20)), {"a": {"b": {}}},
                   {str(i): i for i in range(20)}, [None, True, False]],
}


@pytest.mark.parametrize("kind", sorted(VALUES))
def test_reader_decodes_every_msgpack_type(tmp_path, kind):
    obj = {"v": VALUES[kind]}
    path = str(tmp_path / "blob.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.packb(obj, use_bin_type=True))
    assert tconvert.read_msgpack(path) == obj


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int8", "uint8", "float64"])
def test_reader_decodes_flax_arrays(tmp_path, dtype):
    rng = np.random.default_rng(0)
    tree = {"a": {"x": (rng.standard_normal((3, 5)) * 10).astype(dtype),
                  "s": np.asarray(rng.standard_normal(()) * 10).astype(dtype)[()]}}
    path = str(tmp_path / "t.msgpack.gz")
    with gzip.open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))
    ours = tconvert.read_msgpack(path)
    np.testing.assert_array_equal(ours["a"]["x"], tree["a"]["x"])
    assert ours["a"]["x"].dtype == np.dtype(dtype)
    assert ours["a"]["s"] == tree["a"]["s"]


def test_state_dict_loads_into_the_port_model():
    cfg = ModelConfig.small()
    params = jmmt.init_params(cfg, jax.random.PRNGKey(3))
    model = tmmt.MultimodalTransformer(cfg)
    missing, unexpected = model.load_state_dict(tconvert.from_jax_params(params), strict=True)
    assert not missing and not unexpected
    # the stacked modality encoders split in the order 1H, 13C, HSQC, COSY, IR
    w = np.asarray(params["modality_encoders"]["layers_1"]["linear1"]["kernel"])
    for m, prefix in enumerate(tconvert.ENCODER_TORCH_PREFIXES):
        got = getattr(model, prefix).layers[1].linear1.weight.detach().numpy()
        np.testing.assert_array_equal(got, w[m].T)


# ---------------------------------------------------------------------------
# the reference's PyTorch checkpoints
# ---------------------------------------------------------------------------

MF = "linear_embedding_MF.embedding.weight"


def test_from_torch_state_dict_reads_the_jax_export_of_phase3():
    """JAX's ``to_torch_state_dict`` of phase3, read by the port, is the
    port's phase3 state dict; the MF table's 213th row comes back zero."""
    cfg, params, sd = _phase3()
    ours = tconvert.from_torch_state_dict(cfg, jconvert.to_torch_state_dict(cfg, params))
    assert set(ours) == set(sd)
    for k, v in sd.items():
        got = ours[k]
        assert got.dtype == torch.float32 and got.shape == v.shape, k
        if k == MF:
            assert not got[212].any()
            got, v = got[:212], v[:212]
        assert torch.equal(got, v), k


def test_to_torch_state_dict_equals_jax():
    cfg, params, sd = _phase3()
    ref = jconvert.to_torch_state_dict(cfg, params)
    ours = tconvert.to_torch_state_dict(cfg, sd)
    assert set(ours) == set(ref)
    assert ours[MF].shape == (212, 128)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("kind", ["pth", "lightning_ckpt"])
def test_load_torch_checkpoint_reads_pth_and_lightning_ckpt(tmp_path, kind):
    cfg = ModelConfig.small()
    params = jmmt.init_params(cfg, jax.random.PRNGKey(5))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jconvert.to_torch_state_dict(cfg, params).items()}
    path = str(tmp_path / ("m.pth" if kind == "pth" else "m.ckpt"))
    if kind == "pth":
        torch.save(sd, path)
    else:  # Lightning wraps the model as ``self.model`` and adds its own entries
        torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}, "epoch": 3,
                    "global_step": 120, "hyper_parameters": {"lr": 1e-4}}, path)
    ours = tconvert.load_torch_checkpoint(cfg, path)
    ref = tconvert.from_jax_params(jconvert.load_torch_checkpoint(cfg, path))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k
    model = tmmt.MultimodalTransformer(cfg)
    model.load_state_dict(ours, strict=True)


def test_cli_evaluate_takes_a_torch_checkpoint(tmp_path, monkeypatch):
    """``evaluate --torch-checkpoint`` builds the model from the converted
    checkpoint; ``--params`` wins when both are given."""
    import contextlib
    import io
    import json

    from multimodalspectraltransformer_torch import cli as tcli
    from multimodalspectraltransformer_torch.train import checkpoint as tckpt

    cfg = ModelConfig.small()
    sd = tconvert.to_torch_state_dict(cfg, tmmt.init_model(cfg, seed=2, device="cpu").state_dict())
    ckpt = str(tmp_path / "m.ckpt")
    torch.save({"state_dict": {"model." + k: v for k, v in sd.items()}}, ckpt)
    other = tmmt.init_model(cfg, seed=9, device="cpu")
    msgpack_path = str(tmp_path / "p.msgpack")
    tckpt.export_params_msgpack(other, msgpack_path)
    built = []
    real = tmmt.model_from_state_dict
    monkeypatch.setattr(tmmt, "model_from_state_dict",
                        lambda s, c, d: built.append(s[MF].clone()) or real(s, c, d))
    argv = ["evaluate", "--small", "--synthetic", "2", "--device", "cpu", "--max-len", "12",
            "--fanout", "2", "--multinom-runs", "1", "--rounds", "1", "--torch-checkpoint", ckpt]
    for extra in ([], ["--params", msgpack_path]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tcli.main(argv + extra) == 0
        assert json.loads(out.getvalue().strip().splitlines()[-1])["n"] == 2
    assert torch.equal(built[0][:212], sd[MF]) and not built[0][212].any()
    assert torch.equal(built[1], other.state_dict()[MF])
