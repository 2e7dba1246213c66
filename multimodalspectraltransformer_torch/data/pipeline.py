"""Host-side data: spectra CSVs -> records -> fixed-shape model inputs.

The inference subset of the JAX package's ``data/pipeline.py``, carried as
the port's own copy (numpy, no device code): ``SampleRecord``,
``load_spectra_csvs`` (read with the standard library's ``csv``, where the
JAX package uses pandas), ``bin_ir``, ``_pad_points``, ``featurize`` and
``collate``. Same normalizations: 1H
ppm/10 (intensity untouched), 13C ppm/200, HSQC (H/10, C/200), COSY (H/10,
H/10); zero-pad to ``spectrum_points`` with inverted masks (1 = padding);
IR mean-binned to ``ir_bins`` and max-normalized; SMILES canonicalized and
tokenized with <SOS>/<EOS> framing; 512-bit Morgan fingerprint target.
"""

from __future__ import annotations

import ast
import csv
import os
import random
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..chem import api as chem
from ..chem import tokenizer
from ..models.mmt import MMTBatch
from ..utils.config import ModelConfig

@dataclass
class SampleRecord:
    sample_id: str
    smiles: str
    h1: Optional[list] = None  # [[ppm, intensity], ...]
    c13: Optional[list] = None  # [ppm, ...]
    hsqc: Optional[list] = None  # [[H, C], ...]
    cosy: Optional[list] = None  # [[H, H], ...]
    ir: Optional[np.ndarray] = None  # raw spectrum (any length)


def _parse_shifts(value):
    if isinstance(value, str):
        return ast.literal_eval(value)
    return value


def _read_rows(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_spectra_csvs(
    csv_1h: str = "",
    csv_13c: str = "",
    csv_hsqc: str = "",
    csv_cosy: str = "",
    ir_folder: str = "",
    limit: int = 0,
) -> list[SampleRecord]:
    """Reference-format CSVs (columns ``sample-id``, ``SMILES``, ``shifts``
    holding a Python list literal; IR as ``<ir_folder>/<sample-id>.csv``
    with a ``spectra`` column) -> one record per sample id, in the order ids
    first appear (1H, 13C, HSQC, COSY), the first ``limit`` if set. A shifts
    cell that does not parse gives ``None`` for that modality."""
    tables = {}
    for key, path in (("1H", csv_1h), ("13C", csv_13c), ("HSQC", csv_hsqc), ("COSY", csv_cosy)):
        if path:
            tables[key] = {r["sample-id"]: (r["SMILES"], r["shifts"]) for r in _read_rows(path)}

    ids: list[str] = []
    seen = set()
    for t in tables.values():
        for sid in t:
            if sid not in seen:
                seen.add(sid)
                ids.append(sid)
    if limit:
        ids = ids[:limit]

    records = []
    for sid in ids:
        smiles = None
        fields: dict = {}
        for key, attr in (("1H", "h1"), ("13C", "c13"), ("HSQC", "hsqc"), ("COSY", "cosy")):
            if key in tables and sid in tables[key]:
                smi, shifts = tables[key][sid]
                smiles = smiles or smi
                try:
                    fields[attr] = _parse_shifts(shifts)
                except (ValueError, SyntaxError):
                    fields[attr] = None
        ir = None
        if ir_folder:
            path = os.path.join(ir_folder, f"{sid}.csv")
            if os.path.exists(path):
                ir = np.array([float(r["spectra"]) for r in _read_rows(path)])
        if smiles is None:
            continue
        records.append(SampleRecord(sid, smiles, ir=ir, **fields))
    return records


def bin_ir(raw: np.ndarray, bins: int) -> np.ndarray:
    """Mean-bin + max-normalize (reference `_load_IR_data`, `:324-346`).

    Vectorized: the naive per-bin ``raw[a:b].mean()`` loop costs ~30 ms per
    record (1000 numpy-call dispatches) and dominated corpus featurization.
    Bin edges keep the original accumulated ``start += span`` + banker's
    ``round`` semantics, and segment sums add elements in the same order
    np.mean does for short segments (<8), so outputs are bit-identical for
    the 1801-point IR inputs (segments of 1-2 elements)."""
    raw = np.asarray(raw, dtype=np.float64)
    max_val = raw.max() if raw.size else 1.0
    span = len(raw) / bins
    edges = np.empty(bins + 1, dtype=np.int64)
    start = 0.0
    for i in range(bins + 1):
        edges[i] = round(start)
        start += span
    lo, hi = edges[:-1], edges[1:]
    counts = hi - lo
    out = np.zeros(bins)
    for c in np.unique(counts):
        if c <= 0:
            continue
        rows = np.nonzero(counts == c)[0]
        acc = raw[lo[rows]].copy()
        for k in range(1, int(c)):
            acc += raw[lo[rows] + k]
        out[rows] = acc / float(c) / max_val
    return out


def _pad_points(points: Sequence, length: int, dims: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad to [length(, dims)] with inverted mask (1 = padding),
    truncating overlong lists (reference `_zero_pad`, `:267-299`)."""
    mask = np.ones(length, dtype=np.int32)
    if dims == 1:
        out = np.zeros(length, dtype=np.float32)
        pts = np.asarray(points, dtype=np.float32)[:length]
    else:
        out = np.zeros((length, dims), dtype=np.float32)
        pts = np.asarray([list(p) for p in points], dtype=np.float32)[:length]
    n = len(pts)
    if n:
        out[:n] = pts
        mask[:n] = 0
    return out, mask


@dataclass
class FeaturizeOptions:
    blank_percentage: float = 0.0
    randomize_smiles: bool = False
    # trust rec.smiles as the target form (pre-randomized augmentation
    # variant from augment_records): target/MS-hint tokens use it verbatim
    # instead of the canonical form, keeping featurization DETERMINISTIC so
    # the device-resident dataset path stays usable (randomize_smiles
    # re-rolls per epoch and forces the host path)
    use_given_smiles_form: bool = False
    use_ir: bool = True
    # HSQC noise pollution (reference pollute_HSQC_data,
    # `dataloaders_pl_v15_4.py:117-140`): inject up to `hsqc_noise_max`
    # random extra peaks drawn from a pool (or uniform over the ppm ranges)
    hsqc_noise_max: int = 0
    hsqc_noise_pool: Optional[list] = None  # [(dH, dC), ...]


def pollute_hsqc(
    peaks: list, opts: "FeaturizeOptions", rng: random.Random
) -> list:
    """Add 0..hsqc_noise_max random noise peaks to an HSQC peak list
    (the reference samples from an experimental noise-peak pool; without a
    pool, peaks are drawn uniformly over typical 1H/13C ranges)."""
    if opts.hsqc_noise_max <= 0:
        return peaks
    n = rng.randint(0, opts.hsqc_noise_max)
    out = list(peaks)
    for _ in range(n):
        if opts.hsqc_noise_pool:
            h, c = rng.choice(opts.hsqc_noise_pool)[:2]
        else:
            h, c = rng.uniform(0.0, 10.0), rng.uniform(0.0, 200.0)
        out.append([h, c])
    return out


def featurize(
    rec: SampleRecord,
    mcfg: ModelConfig,
    opts: Optional[FeaturizeOptions] = None,
    rng: Optional[random.Random] = None,
    pre: Optional[tuple] = None,
) -> Optional[dict]:
    """One sample -> fixed-shape numpy features. None if chemistry fails
    (mirrors the reference's silent skip).

    ``pre`` optionally supplies the per-molecule chemistry as
    ``(canonical_smiles, formula, exact_mw, morgan_fp)`` — computed in bulk
    through the threaded native kernel instead
    of four Python SMILES parses per sample. Entries may be None/NaN for
    invalid molecules; outputs are bit-identical either way (the native
    kernel mirrors the Python spec)."""
    opts = opts or FeaturizeOptions()
    rng = rng or random.Random(0)
    P = mcfg.spectrum_points

    if pre is not None:
        c_smi, mf, mw, fp = pre
        if mw is not None and np.isnan(mw):
            mw = None
    else:
        c_smi = chem.canonicalize(rec.smiles)
        if c_smi is None:
            return None
        mf = chem.mol_formula(c_smi)
        mw = chem.exact_mol_wt(c_smi)
        fp = chem.morgan_fp(c_smi, 2, mcfg.fingerprint_size)
    if c_smi is None or mf is None or mw is None or fp is None:
        return None
    if opts.randomize_smiles:
        rnd = chem.randomize(c_smi, rng)
        if rnd is not None:
            c_smi = rnd
    elif opts.use_given_smiles_form:
        c_smi = rec.smiles  # pre-randomized variant (validated above)

    out: dict = {}
    active = []

    def blanked() -> bool:
        return rng.random() < opts.blank_percentage

    # 1H: [ppm/10, intensity]
    if rec.h1 is not None and not blanked():
        pts = [[s[0] / 10.0, s[1]] for s in rec.h1]
        out["src_1h"], out["mask_1h"] = _pad_points(pts, P, 2)
        active.append("1H")
    else:
        out["src_1h"], out["mask_1h"] = np.zeros((P, 2), np.float32), np.ones(P, np.int32)

    # 13C: ppm/200
    if rec.c13 is not None and not blanked():
        pts = [s / 200.0 for s in rec.c13]
        out["src_13c"], out["mask_13c"] = _pad_points(pts, P, 1)
        active.append("13C")
    else:
        out["src_13c"], out["mask_13c"] = np.zeros(P, np.float32), np.ones(P, np.int32)

    # HSQC: [H/10, C/200]
    if rec.hsqc is not None and not blanked():
        hsqc_peaks = pollute_hsqc(rec.hsqc, opts, rng)
        pts = [[p[0] / 10.0, p[1] / 200.0] for p in hsqc_peaks]
        out["src_hsqc"], out["mask_hsqc"] = _pad_points(pts, P, 2)
        active.append("HSQC")
    else:
        out["src_hsqc"], out["mask_hsqc"] = np.zeros((P, 2), np.float32), np.ones(P, np.int32)

    # COSY: [H/10, H/10]
    if rec.cosy is not None and not blanked():
        pts = [[p[0] / 10.0, p[1] / 10.0] for p in rec.cosy]
        out["src_cosy"], out["mask_cosy"] = _pad_points(pts, P, 2)
        active.append("COSY")
    else:
        out["src_cosy"], out["mask_cosy"] = np.zeros((P, 2), np.float32), np.ones(P, np.int32)

    # IR
    if opts.use_ir and rec.ir is not None and not blanked():
        out["src_ir"] = bin_ir(rec.ir, mcfg.ir_bins).astype(np.float32)
        active.append("IR")
    else:
        out["src_ir"] = np.zeros(mcfg.ir_bins, np.float32)

    # all blanked -> restore 1H + 13C (reference `:597-626`)
    if not active:
        if rec.h1 is not None:
            pts = [[s[0] / 10.0, s[1]] for s in rec.h1]
            out["src_1h"], out["mask_1h"] = _pad_points(pts, P, 2)
        if rec.c13 is not None:
            pts = [s / 200.0 for s in rec.c13]
            out["src_13c"], out["mask_13c"] = _pad_points(pts, P, 1)

    out["src_mf"], out["mask_mf"] = tokenizer.encode_mf_framed(mf, mcfg.mf_len)
    # the MS hint has its own declared length (ModelConfig.ms_len drives the
    # encoder's static layout); the decoder target frames to spectrum_points
    out["src_ms"], out["mask_ms"] = tokenizer.encode_smiles_framed(c_smi, mcfg.ms_len)
    trg, _trg_mask = tokenizer.encode_smiles_framed(c_smi, mcfg.spectrum_points)
    out["mw"] = np.float32(mw)
    out["trg_tokens"] = trg.astype(np.int32)
    out["trg_fp"] = fp.astype(np.float32)
    out["smiles"] = c_smi
    out["sample_id"] = rec.sample_id
    return out



class Batch(NamedTuple):
    inputs: MMTBatch  # numpy arrays
    trg_tokens: np.ndarray  # [B, spectrum_points] <SOS>...<EOS> padded
    trg_fp: np.ndarray  # [B, fingerprint_size]


def collate(samples: Sequence[dict]) -> Batch:
    """Stack featurized samples into numpy model inputs and targets."""
    st = lambda k: np.stack([s[k] for s in samples])
    inputs = MMTBatch(
        src_1h=st("src_1h"), mask_1h=st("mask_1h"),
        src_13c=st("src_13c"), mask_13c=st("mask_13c"),
        src_hsqc=st("src_hsqc"), mask_hsqc=st("mask_hsqc"),
        src_cosy=st("src_cosy"), mask_cosy=st("mask_cosy"),
        src_ir=st("src_ir"),
        src_mf=st("src_mf"), mask_mf=st("mask_mf"),
        src_ms=st("src_ms"), mask_ms=st("mask_ms"),
        mw=st("mw"),
    )
    return Batch(inputs, st("trg_tokens"), st("trg_fp"))
