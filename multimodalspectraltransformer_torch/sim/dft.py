"""DFT/Gaussian legacy pipeline: Boltzmann-averaged NMR shifts from
shielding tensors + experimental-data-format loaders.

Reference: `nmr_calculation_from_dft_v15_4.py` — conformer SCF energies ->
Boltzmann factors (`calculate_boltzmann_factors:226`, T=298.15 K,
k=0.001987204 kcal/mol/K), weighted-average isotropic shieldings
(`perform_boltzmann_averaging:244`), shift referencing by solvent standard
(`calculate_nmr_shifts_from_shieldings:260`) or CHESHIRE slope/intercept
(`calculate_nmr_shifts_from_shieldings_slope_intercept:277`,
shift = (intercept - sigma) / -slope), lowest-conformer SDF export
(`save_results_sdf_file:293`), plus loaders for ACD (SDF-embedded HSQC
table), Mnova and "real" peak-list formats (`:953-1013`). Used for paper
comparisons rather than the training loop; all array math here is
vectorized numpy (it is host-side tooling, not a device kernel).

The port's own copy of the JAX package's ``sim/dft.py``; the two peak-list
loaders split their lines with the regular expression pandas is given there
(a tab or a run of whitespace) instead of reading them with pandas.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# Boltzmann constant in kcal/(mol*K) and standard temperature — the
# reference's constants (`nmr_calculation_from_dft_v15_4.py:229-231`).
K_KCAL = 0.001987204
T_STD = 298.15


@dataclass
class ConformerSet:
    """Multi-conformer Gaussian NMR result for one molecule."""

    atoms: list[str]  # element symbols, file order
    energies: np.ndarray  # [n_conf] SCF energies (kcal/mol, any offset)
    shieldings: np.ndarray  # [n_conf, n_atoms] isotropic shieldings (ppm)
    name: str = ""

    def __post_init__(self):
        self.energies = np.asarray(self.energies, dtype=np.float64)
        self.shieldings = np.asarray(self.shieldings, dtype=np.float64)
        assert self.shieldings.shape == (len(self.energies), len(self.atoms))


def boltzmann_weights(energies: np.ndarray, temperature: float = T_STD) -> np.ndarray:
    """Normalized conformer populations from relative energies (kcal/mol)."""
    e = np.asarray(energies, dtype=np.float64)
    rel = e - e.min()
    w = np.exp(-rel / (K_KCAL * temperature))
    return w / w.sum()


def boltzmann_average(conformers: ConformerSet, temperature: float = T_STD) -> np.ndarray:
    """Population-weighted average shielding per atom."""
    w = boltzmann_weights(conformers.energies, temperature)
    return w @ conformers.shieldings


def shifts_linear_scaling(
    atoms: Sequence[str],
    shieldings: np.ndarray,
    slope_h: float,
    intercept_h: float,
    slope_c: float,
    intercept_c: float,
) -> np.ndarray:
    """CHESHIRE-style referencing: shift = (intercept - sigma) / -slope,
    applied per element (C and H; other atoms pass through unchanged)."""
    out = np.asarray(shieldings, dtype=np.float64).copy()
    for i, a in enumerate(atoms):
        if a == "C":
            out[i] = (intercept_c - out[i]) / -slope_c
        elif a == "H":
            out[i] = (intercept_h - out[i]) / -slope_h
    return out


def shifts_solvent_reference(
    atoms: Sequence[str],
    shieldings: np.ndarray,
    c13_shield_calc: float,
    c13_shift_exp: float,
    h1_shield_calc: float,
    h1_shift_exp: float,
) -> np.ndarray:
    """Solvent-standard referencing: shift = sigma_ref - sigma + shift_exp."""
    out = np.asarray(shieldings, dtype=np.float64).copy()
    for i, a in enumerate(atoms):
        if a == "C":
            out[i] = c13_shield_calc - out[i] + c13_shift_exp
        elif a == "H":
            out[i] = h1_shield_calc - out[i] + h1_shift_exp
    return out


# ---------------------------------------------------------------------------
# SDF parsing (no RDKit in the image — first-party minimal V2000 reader)
# ---------------------------------------------------------------------------

_SHIELDING_KEYS = (
    "isotropic shielding",
    "isotropic sheilding",  # the misspelled key Gaussian-processing scripts emit
)
_ENERGY_KEYS = ("scf energy", "energy")


def _looks_like_counts(line: str) -> bool:
    """True when a line parses as a V2000 counts line (nnnmmm...)."""
    try:
        int(line[0:3])
        int(line[3:6])
        return True
    except (ValueError, IndexError):
        return False


def parse_sdf_records(text: str) -> list[dict]:
    """Split an SDF/SD file into records: each with 'name', 'atoms'
    (element symbols), 'bonds' [(a1, a2, order)], and 'props' {tag: text}."""
    records = []
    for chunk in text.split("$$$$"):
        # strip only the record SEPARATOR newlines around the chunk — a
        # blank molfile title line is legal and must keep its position or
        # the counts line shifts and the record is silently dropped
        lines = chunk.splitlines()
        while lines and lines[0].strip() == "" and len(lines) > 4 and not _looks_like_counts(lines[3]):
            lines.pop(0)
        while lines and lines[-1].strip() == "":
            lines.pop()
        if len(lines) < 4:
            continue
        name = lines[0].strip()
        counts = lines[3]
        try:
            n_atoms = int(counts[0:3])
            n_bonds = int(counts[3:6])
        except ValueError:
            continue
        atoms = []
        for ln in lines[4 : 4 + n_atoms]:
            parts = ln.split()
            atoms.append(parts[3] if len(parts) > 3 else "?")
        bonds = []
        for ln in lines[4 + n_atoms : 4 + n_atoms + n_bonds]:
            try:
                a1, a2, order = int(ln[0:3]), int(ln[3:6]), int(ln[6:9])
                bonds.append((a1 - 1, a2 - 1, order))
            except ValueError:
                continue
        props: dict[str, str] = {}
        tag = None
        buf: list[str] = []
        for ln in lines[4 + n_atoms + n_bonds :]:
            m = re.match(r">\s*<(.+?)>", ln)
            if m:
                if tag is not None:
                    props[tag] = "\n".join(buf).strip()
                tag = m.group(1)
                buf = []
            elif tag is not None:
                buf.append(ln)
        if tag is not None:
            props[tag] = "\n".join(buf).strip()
        records.append({"name": name, "atoms": atoms, "bonds": bonds, "props": props})
    return records


def _find_prop(props: dict, keys: Sequence[str]) -> Optional[str]:
    for tag, val in props.items():
        low = tag.lower()
        if any(k in low for k in keys):
            return val
    return None


def load_conformer_set(path_or_text: str) -> ConformerSet:
    """Read a concatenated multi-conformer SDF where each record carries an
    energy property and a whitespace-separated isotropic-shielding list
    (the Gaussian post-processing format of the reference,
    `get_shielding_for_conformers:181`)."""
    text = path_or_text
    if "\n" not in path_or_text:
        with open(path_or_text) as f:
            text = f.read()
    records = parse_sdf_records(text)
    if not records:
        raise ValueError("no SDF records found")
    atoms = records[0]["atoms"]
    energies, shieldings = [], []
    for rec in records:
        e_txt = _find_prop(rec["props"], _ENERGY_KEYS)
        s_txt = _find_prop(rec["props"], _SHIELDING_KEYS)
        if e_txt is None or s_txt is None:
            continue
        vals = [float(v) for v in s_txt.split()]
        if len(vals) != len(atoms):
            continue
        energies.append(float(e_txt.split()[0]))
        shieldings.append(vals)
    if not energies:
        raise ValueError("no conformers with energy + shielding properties")
    return ConformerSet(atoms, np.array(energies), np.array(shieldings), records[0]["name"])


def run_dft_pipeline(
    path_or_text: str,
    slope_h: float = -1.0,
    intercept_h: float = 31.8,
    slope_c: float = -1.0,
    intercept_c: float = 182.0,
    temperature: float = T_STD,
) -> tuple[list[str], np.ndarray]:
    """Full legacy pipeline (`run_script:332`): parse conformers ->
    Boltzmann-average shieldings -> slope/intercept referencing.
    Returns (atom symbols, per-atom shifts). Default scaling factors are
    generic TMS-like placeholders; pass CHESHIRE values for production."""
    confs = load_conformer_set(path_or_text)
    avg = boltzmann_average(confs, temperature)
    shifts = shifts_linear_scaling(confs.atoms, avg, slope_h, intercept_h, slope_c, intercept_c)
    return confs.atoms, shifts


def hsqc_from_dft(atoms: Sequence[str], bonds: Sequence[tuple], shifts: np.ndarray) -> list[tuple[float, float]]:
    """C-H correlation peaks [(dH, dC)] from DFT per-atom shifts using the
    explicit H connectivity in the SDF (`get_c_h_connectivity:760`)."""
    peaks = []
    for a1, a2, _order in bonds:
        s1, s2 = atoms[a1], atoms[a2]
        if {s1, s2} == {"C", "H"}:
            c, h = (a1, a2) if s1 == "C" else (a2, a1)
            peaks.append((float(shifts[h]), float(shifts[c])))
    # average equivalent H on the same carbon (e.g. CH3) like the reference's
    # shift grouping
    grouped: dict[float, list[float]] = {}
    for h, c in peaks:
        grouped.setdefault(round(c, 6), []).append(h)
    return [(float(np.mean(hs)), c) for c, hs in sorted(grouped.items())]


# ---------------------------------------------------------------------------
# Experimental-format loaders (`load_acd_dataframe:953`,
# `load_real_dataframe:995`, `load_mnova_dataframe:1002`)
# ---------------------------------------------------------------------------


def load_acd_hsqc(path: str) -> np.ndarray:
    """ACD SDF export: record property 'HSQC_13C-1H' holds a TSV table with
    'F2 (ppm)' (H) and 'F1 (ppm)' (C) columns; '<' in 'F2 Atom' marks
    negative-phase (CH2) peaks. Returns [n, 3] (H, C, direction)."""
    with open(path) as f:
        records = parse_sdf_records(f.read())
    for rec in records:
        table = _find_prop(rec["props"], ("hsqc_13c-1h",))
        if not table:
            continue
        rows = [r.split(";")[0].split("\t") for r in table.splitlines()]
        header = rows[0]
        f2 = header.index("F2 (ppm)")
        f1 = header.index("F1 (ppm)")
        atom_col = header.index("F2 Atom") if "F2 Atom" in header else None
        out = []
        seen = set()
        need = max(f2, f1, atom_col if atom_col is not None else 0)
        for r in rows[1:]:
            if len(r) <= need:  # truncated row: skip, don't IndexError
                continue
            key = (r[f2], r[f1])
            if key in seen:  # keep='last' dedup of the reference
                out = [o for o in out if (o[3] != key)]
            seen.add(key)
            direction = -1.0 if atom_col is not None and "<" in r[atom_col] else 1.0
            out.append((float(r[f2]), float(r[f1]), direction, key))
        arr = np.array([[h, c, d] for h, c, d, _ in out], dtype=np.float64)
        return arr.reshape(-1, 3)  # shape (0, 3) for header-only tables
    raise ValueError("no HSQC_13C-1H property in SDF")


def _split_rows(path: str) -> list[list[str]]:
    """The non-blank lines of a peak list, split on a tab or a run of
    whitespace, as the JAX package's ``pandas.read_csv`` splits them."""
    with open(path) as f:
        return [re.split(r"\t|\s+", ln.strip()) for ln in f if ln.strip()]


def load_real_hsqc(path: str) -> np.ndarray:
    """Whitespace/tab peak list with F2ppm/F1ppm header columns. [n, 2] (H, C)."""
    header, *rows = _split_rows(path)
    names = {"F2ppm": "F2 (ppm)", "F1ppm": "F1 (ppm)"}
    header = [names.get(h, h) for h in header]
    h, c = header.index("F2 (ppm)"), header.index("F1 (ppm)")
    return np.array([[float(r[h]), float(r[c])] for r in rows], dtype=np.float64).reshape(-1, 2)


def load_mnova_hsqc(path: str) -> np.ndarray:
    """Headerless Mnova export: id, F2 (H), F1 (C), intensity. [n, 2] (H, C)."""
    rows = _split_rows(path)
    return np.array([[float(r[1]), float(r[2])] for r in rows], dtype=np.float64).reshape(-1, 2)
