"""The port's ``sim/dft.py`` against the JAX package's, on the inputs
``tests/test_dft.py`` builds: every function gives the same values, and the
peak-list loaders read the arrays pandas reads."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_dft import ATOMS, BONDS, SDF_TEXT, _sdf_record

from multimodalspectraltransformer_torch.sim import dft as tdft
from multimodalspectraltransformer_tpu.sim import dft as jdft


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_and_boltzmann_match_jax():
    assert (tdft.K_KCAL, tdft.T_STD) == (jdft.K_KCAL, jdft.T_STD)
    for e in (np.array([0.0, 1.0]), np.array([-500.0, -499.0, -498.2]), np.array([3.0])):
        for temp in (tdft.T_STD, 350.0):
            np.testing.assert_array_equal(tdft.boltzmann_weights(e, temp),
                                          jdft.boltzmann_weights(e, temp))


def test_conformers_and_averaging_match_jax():
    ours, ref = tdft.load_conformer_set(SDF_TEXT), jdft.load_conformer_set(SDF_TEXT)
    assert (ours.atoms, ours.name) == (ref.atoms, ref.name)
    np.testing.assert_array_equal(ours.energies, ref.energies)
    np.testing.assert_array_equal(ours.shieldings, ref.shieldings)
    np.testing.assert_array_equal(tdft.boltzmann_average(ours), jdft.boltzmann_average(ref))
    recs = tdft.parse_sdf_records(SDF_TEXT)
    assert recs == jdft.parse_sdf_records(SDF_TEXT) and len(recs) == 2


def test_shift_referencing_matches_jax():
    sh = np.array([180.0, 30.0, 30.5])
    np.testing.assert_array_equal(tdft.shifts_linear_scaling(ATOMS, sh, -1.05, 31.8, -1.02, 182.0),
                                  jdft.shifts_linear_scaling(ATOMS, sh, -1.05, 31.8, -1.02, 182.0))
    np.testing.assert_array_equal(
        tdft.shifts_solvent_reference(ATOMS + ["O"], np.append(sh, 250.0), 190.0, 77.0, 31.0, 7.26),
        jdft.shifts_solvent_reference(ATOMS + ["O"], np.append(sh, 250.0), 190.0, 77.0, 31.0, 7.26))


def test_full_pipeline_and_hsqc_match_jax(tmp_path):
    path = tmp_path / "confs.sdf"
    path.write_text(SDF_TEXT)
    for src in (SDF_TEXT, str(path)):
        atoms, shifts = tdft.run_dft_pipeline(src, slope_c=-1.03, intercept_c=181.0)
        ref_atoms, ref_shifts = jdft.run_dft_pipeline(src, slope_c=-1.03, intercept_c=181.0)
        assert atoms == ref_atoms
        np.testing.assert_array_equal(shifts, ref_shifts)
    assert tdft.hsqc_from_dft(atoms, BONDS, shifts) == jdft.hsqc_from_dft(atoms, BONDS, shifts)


def test_acd_loader_matches_jax(tmp_path):
    table = "\n".join(["F2 (ppm)\tF1 (ppm)\tF2 Atom", "2.10\t25.3\tH7", "3.52\t55.1\t<H9",
                       "3.52\t55.1\t<H9", "1.2\t14.1", "0.91\t22.7\tH3"])
    p = tmp_path / "acd.sdf"
    p.write_text(_sdf_record("acd", ["C"], [], {"HSQC_13C-1H": table}))
    np.testing.assert_array_equal(tdft.load_acd_hsqc(str(p)), jdft.load_acd_hsqc(str(p)))
    q = tmp_path / "none.sdf"
    q.write_text(_sdf_record("x", ["C"], [], {"other": "1"}))
    with pytest.raises(ValueError, match="HSQC_13C-1H"):
        tdft.load_acd_hsqc(str(q))


@pytest.mark.parametrize("text", [
    "F2ppm F1ppm\n2.1 25.3\n3.5 55.1\n",
    "F1ppm\tF2ppm\n25.3\t2.1\n\n55.123456789\t3.5\n",
    "Intensity F2ppm F1ppm\n1000 7.26 128.4\n900 0.9 14.123\n",
])
def test_real_hsqc_loader_reads_what_pandas_reads(tmp_path, text):
    p = tmp_path / "real.txt"
    p.write_text(text)
    ours, ref = tdft.load_real_hsqc(str(p)), jdft.load_real_hsqc(str(p))
    assert ours.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("text", [
    "1 2.1 25.3 1000\n2 3.5 55.1 900\n",
    "1\t2.1\t25.3\t1000\n2\t3.5  55.1\t900\n3 0.123456789 14.1 5\n",
])
def test_mnova_hsqc_loader_reads_what_pandas_reads(tmp_path, text):
    p = tmp_path / "mnova.txt"
    p.write_text(text)
    ours, ref = tdft.load_mnova_hsqc(str(p)), jdft.load_mnova_hsqc(str(p))
    assert ours.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)
