"""The port's examples (``examples/torch_0*.py``) on the CPU beside the JAX
package's: 01's simulated records, CSVs and plots; 03's decode and atom
values from the JAX example's initial parameters; 02 and 04 at a step cap."""

from __future__ import annotations

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_tpu.data import pipeline as jax_dp
from multimodalspectraltransformer_tpu.decode import samplers as jax_samplers
from multimodalspectraltransformer_tpu.models import mmt as jax_mmt
from multimodalspectraltransformer_tpu.utils import vocab as jax_vocab
from multimodalspectraltransformer_torch.data import pipeline as dp
from multimodalspectraltransformer_torch.models import convert
from torch_test_support import load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_example_01_matches_the_jax_example(tmp_path):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    load("examples/01_data_generation.py").main(jax_out)
    records = load("examples/torch_01_data_generation.py").main(port_out, device="cpu")
    assert len(records) == 4
    assert sorted(os.listdir(jax_out)) == sorted(os.listdir(port_out))
    assert sorted(os.listdir(os.path.join(jax_out, "IR_data"))) == sorted(
        os.listdir(os.path.join(port_out, "IR_data")))
    for name in os.listdir(jax_out):  # the NMR CSVs and the plots, byte for byte
        if name.endswith((".csv", ".svg")):
            assert filecmp.cmp(os.path.join(jax_out, name), os.path.join(port_out, name),
                               shallow=False), name
    theirs = dp.load_spectra_csvs(**{f"csv_{k.lower()}": os.path.join(jax_out, f"data_{k}_demo.csv")
                                     for k in ("1H", "13C", "HSQC", "COSY")},
                                  ir_folder=os.path.join(jax_out, "IR_data"))
    assert [r.smiles for r in theirs] == [r.smiles for r in records]
    for a, b in zip(records, theirs):
        for attr in ("h1", "c13", "hsqc", "cosy", "ir"):
            np.testing.assert_allclose(np.asarray(getattr(a, attr), float),
                                       np.asarray(getattr(b, attr), float), rtol=0, atol=1e-5,
                                       err_msg=attr)


def test_example_03_matches_the_jax_example_on_its_parameters(tmp_path):
    """The JAX example's model, parameters (PRNGKey(0)) and decode beside the
    port's example given the same parameters converted."""
    jex = load("examples/03_explainability.py")
    mcfg = jex.ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=128)
    params = jax_mmt.init_params(mcfg, jax.random.PRNGKey(0))
    # 03_explainability.py:44-60
    feat = jax_dp.featurize(jax_dp.synthetic_dataset(1, seed=3)[0], mcfg)
    tb = jax_dp.collate([feat])
    enc = jax_mmt.MultimodalTransformer(mcfg).apply(
        {"params": params}, jax.tree.map(jnp.asarray, tb.inputs), None, True)
    res = jax_samplers.greedy_decode(params, mcfg, enc.memory, enc.memory_key_padding_mask, 1.0, 48)
    gen = jax_vocab.ids_to_smiles(np.asarray(res.tokens)[0])
    vals = jex.token_probs_to_atom_values(feat["smiles"], np.asarray(res.token_probs)[0].tolist())
    jex.main(str(tmp_path / "jax.svg"))

    out = load("examples/torch_03_explainability.py").main(
        str(tmp_path / "port.svg"), device="cpu",
        params=convert.from_jax_params(jax.tree.map(np.asarray, params)))
    assert out["target"] == feat["smiles"] and out["generated"] == gen
    n = len(out["atom_values"])
    want = (vals + [0.5] * n)[:n]
    np.testing.assert_allclose(out["atom_values"], want, rtol=0, atol=1e-5)
    assert filecmp.cmp(tmp_path / "jax.svg", tmp_path / "port.svg", shallow=False)


def test_example_02_runs_at_a_step_cap():
    result, summary = load("examples/torch_02_train_and_evaluate.py").main(device="cpu", max_steps=2)
    assert result.steps == 2 and np.isfinite(result.train_loss)
    assert summary.n == 8 and 0.0 <= summary.greedy_validity <= 1.0


def test_example_04_runs_at_a_step_cap():
    reports = load("examples/torch_04_improvement_cycle.py").main(device="cpu", steps_per_cycle=2)
    assert [r.cycle for r in reports] == [0, 1]
    assert all(r.n_augmented > 0 and np.isfinite(r.train_loss) for r in reports)
