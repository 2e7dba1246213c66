"""Spectra CSVs -> records -> fixed-shape model inputs -> training batches.

The port's copy of the JAX package's ``data/pipeline.py``: ``SampleRecord``,
``load_spectra_csvs`` (read with the standard library's ``csv``, where the
JAX package uses pandas), ``load_real_example`` (the AZ format of
experimental spectra), ``bin_ir``, ``_pad_points``, ``featurize``,
``collate``, the ``Loader`` of training batches with its device-resident
dataset (``device_dataset``, ``gather_rows``), the synthetic fixtures
(``synthetic_dataset``) and the SMILES-variant expansion
(``augment_records``). Same normalizations: 1H
ppm/10 (intensity untouched), 13C ppm/200, HSQC (H/10, C/200), COSY (H/10,
H/10); zero-pad to ``spectrum_points`` with inverted masks (1 = padding);
IR mean-binned to ``ir_bins`` and max-normalized; SMILES canonicalized and
tokenized with <SOS>/<EOS> framing; 512-bit Morgan fingerprint target.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import gzip
import hashlib
import os
import pickle
import random
import sys
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..chem import api as chem
from ..chem import tokenizer
from ..models.mmt import MMTBatch
from ..utils.config import ModelConfig
from ..utils.device import DeviceLike, resolve_device
from . import samplers

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


# the names a record pickle may hold: numpy's array and scalar reconstructors
# (under numpy 1.x's ``numpy.core`` paths too), the builtins of plain data and
# protocol 2's bytes encoding
_PICKLE_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                         "numpy.core.numeric", "numpy._core.numeric")
_PICKLE_NUMPY_NAMES = {"_reconstruct", "scalar", "dtype", "ndarray", "_frombuffer"}
_PICKLE_BUILTINS = {"list", "dict", "tuple", "set", "frozenset", "int", "float", "complex",
                    "bool", "str", "bytes", "bytearray", "slice", "range"}
_RECORD_CLASSES = ("multimodalspectraltransformer_tpu.data.pipeline",
                   "multimodalspectraltransformer_torch.data.pipeline")


class _RecordUnpickler(pickle.Unpickler):
    """Unpickles record lists that either package wrote, without importing
    the JAX package: its ``SampleRecord`` (the same fields) becomes the
    port's; numpy and plain builtins pass; any other name is refused."""

    def find_class(self, module: str, name: str):
        if module in _RECORD_CLASSES and name == "SampleRecord":
            return SampleRecord
        if ((module in _PICKLE_NUMPY_MODULES and name in _PICKLE_NUMPY_NAMES)
                or module == "numpy.dtypes"
                or (module == "builtins" and name in _PICKLE_BUILTINS)
                or (module, name) == ("_codecs", "encode")):
            return super().find_class(module, name)
        if module.startswith("multimodalspectraltransformer_tpu"):
            raise pickle.UnpicklingError(
                f"record pickle holds {module}.{name}: only the JAX package's SampleRecord "
                "maps onto the port")
        raise pickle.UnpicklingError(f"record pickle holds {module}.{name}, which a record "
                                     "pickle never needs; refusing to load it")


def load_records_pickle(path: str):
    """What a records pickle holds (``.gz`` or plain): a factory cache's
    ``{"n", "seed", "records"}`` dict or a bare record list, written by the
    JAX package or the port. Its ``SampleRecord`` objects are the port's."""
    with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
        return _RecordUnpickler(f).load()


def ref_testset_split(sample_id: str) -> str:
    """Stable 50/50 split of the reference's shipped test molecules into an
    'adapt' half (may supply domain-adaptation training signal) and an
    'eval' half that no training may touch, keyed on the sample id (the
    JAX package's split, id for id)."""
    h = int(hashlib.sha1(sample_id.encode()).hexdigest(), 16)
    return "adapt" if h % 2 == 0 else "eval"


def load_reference_testset(
    csv_13c: str = "",
    csv_hsqc: str = "",
    csv_cosy: str = "",
    csv_1h: str = "",
    limit: int = 0,
) -> list[SampleRecord]:
    """The reference's shipped held-out test sets: headerless CSVs of
    ``SMILES,"[data]",sample-id`` rows, one file per modality over the same
    molecules (``ML_NMR_5M_XL_{13C,HSQC,COSY}_test_10x100.csv`` and
    ``ML_NMR_1H_combined_ZINC_test_10x100.csv``).

    Payloads: 13C a flat shift list, HSQC ``[H, C]`` pairs, COSY ``(H, H)``
    tuples, 1H ``(ppm, relative-intensity)`` peaks, all
    ``ast.literal_eval``-able; tuples become the lists ``featurize`` reads.
    Records are joined by sample id, in order of first appearance; rows
    that do not parse are skipped."""
    tables: dict[str, dict] = {}
    for key, path in (("1H", csv_1h), ("13C", csv_13c), ("HSQC", csv_hsqc), ("COSY", csv_cosy)):
        if not path:
            continue
        t: dict = {}
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if len(row) < 3:
                    continue
                smi, data, sid = row[0].strip(), row[1], row[2].strip()
                try:
                    parsed = _parse_shifts(data)
                except (ValueError, SyntaxError):
                    continue
                if key != "13C":
                    parsed = [list(p) for p in parsed]
                t[sid] = (smi, parsed)
        tables[key] = t

    ids: list[str] = []
    seen: set = set()
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
                smi, data = tables[key][sid]
                smiles = smiles or smi
                fields[attr] = data
        if smiles is None:
            continue
        records.append(SampleRecord(sid, smiles, **fields))
    return records


# the reference's shipped test CSVs (its ``MMT_website/Runfolder/CSV_files/``)
# and where they are looked for by default: that directory in this repository
REF_TESTSET_FILES = {"13c": "ML_NMR_5M_XL_13C_test_10x100.csv",
                     "hsqc": "ML_NMR_5M_XL_HSQC_test_10x100.csv",
                     "cosy": "ML_NMR_5M_XL_COSY_test_10x100.csv",
                     "1h": "ML_NMR_1H_combined_ZINC_test_10x100.csv"}
REF_TESTSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "MMT_website", "Runfolder", "CSV_files")


def load_reference_sets(ref_dir: str) -> tuple[list[SampleRecord], list[SampleRecord]]:
    """The two shipped test sets in ``ref_dir``: the records of the
    13C/HSQC/COSY files and those of the 1H file (other molecules)."""
    chc = load_reference_testset(**{f"csv_{m}": os.path.join(ref_dir, REF_TESTSET_FILES[m])
                                    for m in ("13c", "hsqc", "cosy")})
    h1 = load_reference_testset(csv_1h=os.path.join(ref_dir, REF_TESTSET_FILES["1h"]))
    return chc, h1


def load_real_example(dir_path: str, use_ir: bool = True, limit: int = 0) -> list[SampleRecord]:
    """Experimental spectra in the AZ example format (the input of the
    reference's /run_model_exp_data route): semicolon-separated
    ``real_{1H,13C,HSQC,COSY}_with_AZ_SMILES_v3.csv`` with a
    ``sample-id;shifts;SN_Number;AZ_Number;SMILES`` header, and
    ``real_IR/<sample-id>.csv`` with ``wavelength,spectra`` columns. The
    SMILES lose their stereo markers, then their explicit ``[H]`` atoms, and
    are canonicalized (the vocabulary has no [H] token); a row whose shifts
    do not parse is skipped. Records in the order ids first appear (1H, 13C,
    HSQC, COSY), the first ``limit`` if set."""
    from ..chem import cleaning

    by_id: dict[str, SampleRecord] = {}
    order: list[str] = []
    for key, attr in (("1H", "h1"), ("13C", "c13"), ("HSQC", "hsqc"), ("COSY", "cosy")):
        path = os.path.join(dir_path, f"real_{key}_with_AZ_SMILES_v3.csv")
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            for row in csv.DictReader(f, delimiter=";"):
                sid = row["sample-id"].strip()
                try:
                    data = _parse_shifts(row["shifts"])
                except (ValueError, SyntaxError):
                    continue
                if key != "13C":
                    data = [list(p) for p in data]
                if sid not in by_id:
                    # stereo first ([C@] -> C restores the implicit H), then
                    # the explicit [H] atoms
                    smi = cleaning.remove_stereo(row["SMILES"].strip()).replace("[H]", "")
                    can = chem.canonicalize(smi)
                    if can is None:
                        continue
                    by_id[sid] = SampleRecord(sid, can)
                    order.append(sid)
                setattr(by_id[sid], attr, data)
    if use_ir:
        for sid, rec in by_id.items():
            path = os.path.join(dir_path, "real_IR", f"{sid}.csv")
            if os.path.exists(path):
                rec.ir = np.asarray([float(r["spectra"]) for r in _read_rows(path)])
    recs = [by_id[s] for s in order]
    return recs[:limit] if limit else recs


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


# Bump when featurize/collate output changes (keys the on-disk feature cache;
# refactors that keep the output must not bump it). The JAX package's value:
# caches are shared between the packages.
FEATURIZE_SCHEMA_VERSION = 2  # v2: compact storage dtypes (compact_train_batch)


def _chemistry(rec: SampleRecord, mcfg: ModelConfig, pre: Optional[tuple] = None
               ) -> Optional[tuple]:
    """``(canonical_smiles, formula, exact_mw, morgan_fp)`` of a record, or
    None where the chemistry fails (``featurize`` then skips the record)."""
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
    return c_smi, mf, mw, fp


def _draws(rec: SampleRecord, c_smi: str, opts: FeaturizeOptions, rng: random.Random) -> tuple:
    """Every random draw ``featurize`` makes for one record, in its order: the
    SMILES form, then which spectra stay (not blanked) and the polluted HSQC
    peaks. Returns ``(smiles, keep_1h, keep_13c, hsqc_peaks or None,
    keep_cosy, keep_ir)``."""
    if opts.randomize_smiles:
        rnd = chem.randomize(c_smi, rng)
        if rnd is not None:
            c_smi = rnd
    elif opts.use_given_smiles_form:
        c_smi = rec.smiles  # pre-randomized variant (validated by the chemistry)

    def blanked() -> bool:
        return rng.random() < opts.blank_percentage

    keep_1h = rec.h1 is not None and not blanked()
    keep_13c = rec.c13 is not None and not blanked()
    hsqc = (pollute_hsqc(rec.hsqc, opts, rng)
            if rec.hsqc is not None and not blanked() else None)
    keep_cosy = rec.cosy is not None and not blanked()
    keep_ir = opts.use_ir and rec.ir is not None and not blanked()
    return c_smi, keep_1h, keep_13c, hsqc, keep_cosy, keep_ir


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

    props = _chemistry(rec, mcfg, pre)
    if props is None:
        return None
    _, mf, mw, fp = props
    c_smi, keep_1h, keep_13c, hsqc_peaks, keep_cosy, keep_ir = _draws(rec, props[0], opts, rng)

    out: dict = {}
    active = []

    # 1H: [ppm/10, intensity]
    if keep_1h:
        pts = [[s[0] / 10.0, s[1]] for s in rec.h1]
        out["src_1h"], out["mask_1h"] = _pad_points(pts, P, 2)
        active.append("1H")
    else:
        out["src_1h"], out["mask_1h"] = np.zeros((P, 2), np.float32), np.ones(P, np.int32)

    # 13C: ppm/200
    if keep_13c:
        pts = [s / 200.0 for s in rec.c13]
        out["src_13c"], out["mask_13c"] = _pad_points(pts, P, 1)
        active.append("13C")
    else:
        out["src_13c"], out["mask_13c"] = np.zeros(P, np.float32), np.ones(P, np.int32)

    # HSQC: [H/10, C/200]
    if hsqc_peaks is not None:
        pts = [[p[0] / 10.0, p[1] / 200.0] for p in hsqc_peaks]
        out["src_hsqc"], out["mask_hsqc"] = _pad_points(pts, P, 2)
        active.append("HSQC")
    else:
        out["src_hsqc"], out["mask_hsqc"] = np.zeros((P, 2), np.float32), np.ones(P, np.int32)

    # COSY: [H/10, H/10]
    if keep_cosy:
        pts = [[p[0] / 10.0, p[1] / 10.0] for p in rec.cosy]
        out["src_cosy"], out["mask_cosy"] = _pad_points(pts, P, 2)
        active.append("COSY")
    else:
        out["src_cosy"], out["mask_cosy"] = np.zeros((P, 2), np.float32), np.ones(P, np.int32)

    # IR
    if keep_ir:
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



class TrainBatch(NamedTuple):
    inputs: MMTBatch  # numpy arrays or tensors
    trg_tokens: np.ndarray  # [B, spectrum_points] <SOS>...<EOS> padded
    trg_fp: np.ndarray  # [B, fingerprint_size]


def collate(samples: Sequence[dict]) -> TrainBatch:
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
    return TrainBatch(inputs, st("trg_tokens"), st("trg_fp"))


def to_device(batch: TrainBatch, device) -> TrainBatch:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return TrainBatch(batch.inputs.to(device), torch.as_tensor(batch.trg_tokens).to(device),
                      torch.as_tensor(batch.trg_fp).to(device))


@dataclass
class Loader:
    """Deterministic, seeded batch iterator over featurized records.

    ``epoch`` featurizes on the host (caching deterministic features across
    epochs) and yields numpy batches; ``device_dataset`` featurizes every
    record once into one compact batch on the device, and
    ``epoch_row_batches`` + ``gather_rows`` assemble the same epoch's batches
    there. ``order_strategy``: "shuffle", "weight_sorted" or "tanimoto"
    (``data/samplers.py``).

    Sharding, as the JAX package's: host ``host_id`` of ``host_count`` takes a
    contiguous, truncated block of every epoch order (``_host_slice``);
    ``epoch(..., part=(i, n))`` yields a rank's rows of each global batch;
    ``device_dataset_sharded`` keeps a rank's partition of the featurized rows
    on its device, and ``epoch_row_batches_sharded`` draws each partition's
    rows of every batch.
    """

    records: list
    mcfg: ModelConfig
    batch_size: int
    opts: FeaturizeOptions = field(default_factory=FeaturizeOptions)
    seed: int = 0
    host_id: int = 0
    host_count: int = 1
    drop_remainder: bool = True
    order_strategy: str = "shuffle"
    cache_features: bool = True
    _feature_cache: dict = field(default_factory=dict, repr=False)
    _canonical_cache: dict = field(default_factory=dict, init=False, repr=False)
    _device_dataset: Optional[TrainBatch] = field(default=None, init=False, repr=False)
    _device_kept_smiles: Optional[list] = field(default=None, init=False, repr=False)
    _device_partition: Optional[TrainBatch] = field(default=None, init=False, repr=False)
    _device_shard_extent: Optional[int] = field(default=None, init=False, repr=False)

    def __len__(self) -> int:
        return len(self.records) // self.host_count // self.batch_size

    def _stochastic(self) -> bool:
        return (self.opts.blank_percentage > 0 or self.opts.randomize_smiles
                or self.opts.hsqc_noise_max > 0)

    def _host_slice(self, order):
        """This host's share of an epoch order: a contiguous block (the ordering
        strategies build their structure as contiguous batch runs, which a
        stride would interleave away), truncated to the common per-host length
        (unequal lengths would leave one host in a step the others never
        join)."""
        if self.host_count <= 1:
            return order
        per_host = len(order) // self.host_count
        return order[self.host_id * per_host : (self.host_id + 1) * per_host]

    def epoch(self, epoch: int, part: Optional[tuple[int, int]] = None) -> Iterator[TrainBatch]:
        """The epoch's batches. With ``part=(i, n)``, block ``i`` of ``n``
        contiguous rows of each (the rows a data-parallel rank trains on). The
        records that fail their chemistry and the random stream decide each
        batch, so every record of the order still takes its chemistry (its
        canonical form is kept across epochs) and its draws (``_draws``); a
        row is featurized only where it falls in the block, from the stream's
        state at that row, and so equals that row of the whole batch."""
        order = samplers.epoch_order(self.order_strategy, [r.smiles for r in self.records],
                                     self.batch_size, self.seed, epoch)
        order = self._host_slice(order)
        rng = random.Random(self.seed * 1_000_003 + epoch * 1009 + self.host_id)
        use_cache = self.cache_features and not self._stochastic()
        # features, or with ``part`` (record index, stream state, chemistry)
        buf: list = []
        for idx in order:
            idx = int(idx)
            if part is None:
                feat = self._features(idx, rng, use_cache)
                if feat is None:
                    continue
                buf.append(feat)
            else:
                c_smi, props = self._canonical(idx)
                if c_smi is None:
                    continue
                buf.append((idx, rng.getstate(), props))
                _draws(self.records[idx], c_smi, self.opts, rng)
            if len(buf) == self.batch_size:
                yield self._collate(buf, part, use_cache)
                buf = []
        if buf and not self.drop_remainder:
            yield self._collate(buf, part, use_cache)

    def _features(self, idx: int, rng: random.Random, use_cache: bool,
                  pre: Optional[tuple] = None) -> Optional[dict]:
        if use_cache and idx in self._feature_cache:
            return self._feature_cache[idx]
        feat = featurize(self.records[idx], self.mcfg, self.opts, rng, pre)
        if use_cache:
            self._feature_cache[idx] = feat
        return feat

    def _canonical(self, idx: int) -> tuple[Optional[str], Optional[tuple]]:
        """Record ``idx``'s canonical SMILES (None where its chemistry fails)
        and, when this call computed it, its whole chemistry."""
        if idx in self._canonical_cache:
            return self._canonical_cache[idx], None
        props = _chemistry(self.records[idx], self.mcfg)
        self._canonical_cache[idx] = None if props is None else props[0]
        return self._canonical_cache[idx], props

    def _collate(self, buf: list, part: Optional[tuple[int, int]], use_cache: bool
                 ) -> TrainBatch:
        if part is None:
            return collate(buf)
        feats = []
        for idx, state, props in _part(buf, part):
            rng = random.Random()
            rng.setstate(state)
            feats.append(self._features(idx, rng, use_cache, props))
        return collate(feats)

    # ---- device-resident dataset -----------------------------------------
    #
    # Compact storage dtypes: spectra float16 (far finer than the bf16 the
    # compute path rounds them to), masks int8, token ids uint8 (SMILES vocab
    # 43, MF vocab 212), fingerprint bits int8; ``gather_rows`` restores the
    # canonical float32/int32 per batch. About 4.1 KB a record.
    _F16_FIELDS = ("src_1h", "src_13c", "src_hsqc", "src_cosy", "src_ir")
    _I8_FIELDS = ("mask_1h", "mask_13c", "mask_hsqc", "mask_cosy", "mask_mf", "mask_ms")
    _U8_FIELDS = ("src_mf", "src_ms")

    @classmethod
    def compact_train_batch(cls, big: TrainBatch) -> TrainBatch:
        """Re-encode a featurized numpy batch with the compact storage dtypes
        (idempotent)."""
        rep = {}
        for k in MMTBatch._fields:
            v = np.asarray(getattr(big.inputs, k))
            if k in cls._F16_FIELDS:
                v = v.astype(np.float16)
            elif k in cls._I8_FIELDS:
                v = v.astype(np.int8)
            elif k in cls._U8_FIELDS:
                if v.size and (v.min() < 0 or v.max() >= 256):
                    raise ValueError(f"{k} exceeds uint8")
                v = v.astype(np.uint8)
            rep[k] = v  # mw stays float32: the exact conditioning value
        trg = np.asarray(big.trg_tokens)
        if trg.size and (trg.min() < 0 or trg.max() >= 256):
            raise ValueError("trg_tokens exceeds uint8")
        return TrainBatch(MMTBatch(**rep), trg.astype(np.uint8),
                          np.asarray(big.trg_fp).astype(np.int8))

    def features_digest(self) -> str:
        """Content hash of the featurized form of this dataset, as the JAX
        package computes it (so either package finds the other's cache): the
        schema version, the model's static layout, the featurize options'
        ``repr``, the records' SMILES and spectra."""
        h = hashlib.sha256()
        h.update(str(FEATURIZE_SCHEMA_VERSION).encode())
        m = self.mcfg
        h.update(repr((m.spectrum_points, m.ir_bins, m.mf_len, m.ms_len,
                       m.fingerprint_size)).encode())
        h.update(repr(dataclasses.asdict(self.opts)).encode())
        h.update(str(len(self.records)).encode())
        for r in self.records:
            h.update(r.smiles.encode())
            for v in (r.h1, r.c13, r.hsqc, r.cosy, r.ir):
                h.update(b";")
                if v is not None:
                    h.update(np.asarray(v, np.float32).tobytes())
            h.update(b"\n")
        return h.hexdigest()[:16]

    @staticmethod
    def _save_features_npz(path: str, big: TrainBatch, kept_idx: np.ndarray) -> None:
        arrays = {f"inputs_{k}": getattr(big.inputs, k) for k in MMTBatch._fields}
        arrays["trg_tokens"] = big.trg_tokens
        arrays["trg_fp"] = big.trg_fp
        arrays["kept_idx"] = np.asarray(kept_idx, np.int64)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    @staticmethod
    def _load_features_npz(path: str) -> tuple[TrainBatch, Optional[np.ndarray]]:
        with np.load(path) as z:
            inputs = MMTBatch(**{k: z[f"inputs_{k}"] for k in MMTBatch._fields})
            kept = z["kept_idx"] if "kept_idx" in z.files else None  # older caches: all rows
            return TrainBatch(inputs, z["trg_tokens"], z["trg_fp"]), kept

    def _featurize_records(self):
        """Featurize every record into one compact numpy batch -> (batch, kept
        record indices); None when nothing featurizes."""
        # bulk chemistry through the threaded native library: canonicalize
        # once, then formula, MW and fingerprint of the canonical forms
        canons = chem.batch_canonicalize([r.smiles for r in self.records])
        safe = [c if c is not None else "" for c in canons]
        mfs = chem.batch_mol_formula(safe)
        mws = chem.batch_exact_mol_wt(safe)
        fps, fp_ok = chem.batch_morgan_fp(safe, 2, self.mcfg.fingerprint_size)
        feats, kept = [], []
        for i, r in enumerate(self.records):
            pre = (canons[i], mfs[i] if canons[i] is not None else None, float(mws[i]),
                   fps[i] if fp_ok[i] else None)
            f = featurize(r, self.mcfg, self.opts, pre=pre)
            if f is not None:
                feats.append(f)
                kept.append(i)
        if not feats:
            return None
        if len(feats) != len(self.records):
            print(f"device_dataset: dropping {len(self.records) - len(feats)} records that "
                  f"failed featurization (keeping the device path with {len(feats)} records)",
                  file=sys.stderr)
        return self.compact_train_batch(collate(feats)), np.asarray(kept, np.int64)

    def _featurize_all(self, max_bytes: int):
        """Every record featurized into one compact numpy batch -> (batch, kept
        record indices); None (with the reason printed) when featurization is
        stochastic, nothing featurizes or the batch exceeds ``max_bytes``.
        With ``MMT_FEATURE_CACHE=<dir>`` the batch is read from, or written
        to, ``<dir>/mmt_features_<features_digest>.npz``."""
        if self._stochastic():
            print("device_dataset: featurization is stochastic (per-epoch SMILES "
                  "randomization / blanking / noise); falling back to the host loader")
            return None
        cache_dir = os.environ.get("MMT_FEATURE_CACHE", "")
        cache_path = None
        out = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(cache_dir, f"mmt_features_{self.features_digest()}.npz")
            if os.path.exists(cache_path):
                out = self._load_features_npz(cache_path)
                print(f"device_dataset: loaded featurized cache {cache_path}")
        if out is None:
            out = self._featurize_records()
            if out is None:
                return None
            if cache_path is not None:
                self._save_features_npz(cache_path, *out)
                print(f"device_dataset: wrote featurized cache {cache_path}")
        big, kept = out
        big = self.compact_train_batch(big)  # older caches hold the float32 form
        if kept is None:
            kept = np.arange(len(self.records), dtype=np.int64)
        nbytes = sum(np.asarray(x).nbytes for x in (*big.inputs, big.trg_tokens, big.trg_fp))
        if nbytes > max_bytes:
            print(f"device_dataset: featurized set is {nbytes / (1 << 30):.1f} GiB > cap "
                  f"{max_bytes / (1 << 30):.1f} GiB; falling back to the host path (raise "
                  "MMT_DEVICE_DATASET_GB if it fits the card)", file=sys.stderr)
            return None
        return big, kept

    def device_dataset(self, device: DeviceLike = None,
                       max_bytes: Optional[int] = None) -> Optional[TrainBatch]:
        """Every featurizable record in one compact batch on ``device`` (cuda
        unless asked otherwise); None when featurization is stochastic or the
        set exceeds ``max_bytes`` (default ``MMT_DEVICE_DATASET_GB`` GiB, 6
        when unset). Made once and cached; ``MMT_FEATURE_CACHE`` keeps the
        featurized arrays on disk (``_featurize_all``)."""
        if self._device_dataset is not None:
            return self._device_dataset
        dev = resolve_device(device)
        if max_bytes is None:
            max_bytes = int(float(os.environ.get("MMT_DEVICE_DATASET_GB", "6")) * (1 << 30))
        out = self._featurize_all(max_bytes)
        if out is None:
            return None
        big, kept = out
        self._device_kept_smiles = [self.records[int(i)].smiles for i in kept]
        self._device_dataset = to_device(big, dev)
        return self._device_dataset

    def device_dataset_sharded(self, mesh, device: DeviceLike = None,
                               max_bytes: Optional[int] = None) -> Optional[TrainBatch]:
        """This rank's partition of the featurized rows on ``device``: the
        rows are split into ``data_extent(mesh)`` equal partitions (the
        remainder, under one row a partition, dropped) and data-parallel rank
        ``i`` holds partition ``i``. ``max_bytes`` caps a partition. None as
        ``device_dataset`` returns None, or when there are fewer rows than
        partitions. Batches come from ``epoch_row_batches_sharded`` and
        ``gather_rows`` on the partition, without a collective."""
        from ..parallel.mesh import data_extent, rank_shard

        ext = data_extent(mesh)
        if self._device_partition is not None and self._device_shard_extent == ext:
            return self._device_partition
        dev = resolve_device(device)
        if max_bytes is None:
            max_bytes = int(float(os.environ.get("MMT_DEVICE_DATASET_GB", "6")) * (1 << 30))
        out = self._featurize_all(max_bytes * ext)
        if out is None:
            return None
        big, kept = out
        R = big.trg_tokens.shape[0]
        Rl = R // ext
        if Rl == 0:
            print("device_dataset_sharded: fewer rows than shards; host loader")
            return None
        rows = rank_shard(mesh).rows(Rl)
        self._device_kept_smiles = [self.records[int(i)].smiles for i in kept[: Rl * ext]]
        self._device_shard_extent = ext
        local = TrainBatch(MMTBatch(*(x[rows] for x in big.inputs)), big.trg_tokens[rows],
                           big.trg_fp[rows])
        self._device_partition = to_device(local, dev)
        return self._device_partition

    def epoch_row_batches_sharded(self, epoch: int, n_shards: int) -> Iterator[np.ndarray]:
        """Per-batch local row indices for the sharded dataset: segment ``d``
        of each ``[batch_size]`` array holds ``batch_size / n_shards`` indices
        into partition ``d``, drawn from it by the ordering strategy with the
        seed ``seed * 1_000_003 + d``. A rank gathers its segment from its
        partition."""
        if self._device_kept_smiles is None:
            raise RuntimeError("call device_dataset_sharded() first")
        if self.batch_size % n_shards:
            raise ValueError(f"batch {self.batch_size} not divisible by {n_shards} shards")
        bs_local = self.batch_size // n_shards
        Rl = len(self._device_kept_smiles) // n_shards
        orders = [samplers.epoch_order(self.order_strategy,
                                       self._device_kept_smiles[d * Rl : (d + 1) * Rl], bs_local,
                                       self.seed * 1_000_003 + d, epoch)
                  for d in range(n_shards)]
        for i in range(Rl // bs_local):
            yield np.concatenate([np.asarray(o[i * bs_local : (i + 1) * bs_local], np.int32)
                                  for o in orders])

    def epoch_row_batches(self, epoch: int) -> Iterator[np.ndarray]:
        """Per-batch row indices into ``device_dataset()``, in the order
        ``epoch`` uses (rows index the featurizable records)."""
        if self._device_kept_smiles is None:
            raise RuntimeError("call device_dataset() first")
        order = samplers.epoch_order(self.order_strategy, self._device_kept_smiles,
                                     self.batch_size, self.seed, epoch)
        order = self._host_slice(order)
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield np.asarray(order[i : i + self.batch_size], np.int32)
        rem = len(order) % self.batch_size
        if rem and not self.drop_remainder:
            yield np.asarray(order[-rem:], np.int32)


def _part(rows: list, part: Optional[tuple[int, int]]) -> list:
    """Block ``i`` of ``n`` contiguous rows (all of them without ``part``)."""
    if part is None:
        return rows
    i, n = part
    if len(rows) % n:
        raise ValueError(f"a batch of {len(rows)} rows does not split {n} ways")
    k = len(rows) // n
    return rows[i * k : (i + 1) * k]


def _canonical(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in (torch.float16, torch.bfloat16):
        return x.float()
    if x.dtype in (torch.int8, torch.uint8):
        return x.int()
    return x


def gather_rows(dataset: TrainBatch, idx) -> TrainBatch:
    """Rows ``idx`` of a device dataset, gathered on its device, with the
    compact storage dtypes restored to float32/int32."""
    idx = torch.as_tensor(idx, device=dataset.trg_tokens.device).long()
    inputs = MMTBatch(*(_canonical(x[idx]) for x in dataset.inputs))
    return TrainBatch(inputs, _canonical(dataset.trg_tokens[idx]), dataset.trg_fp[idx].float())


# --------------------------------------------------------------------------
# Synthetic data: plausible molecules + pseudo-spectra for tests and smoke runs
# --------------------------------------------------------------------------

_FRAGMENTS = [
    "CC", "CCC", "CC(C)", "CCO", "CC=O", "C(=O)O", "C(=O)N", "CN", "CO",
    "c1ccccc1", "c1ccncc1", "c1ccc(cc1)", "C1CCCCC1", "CCl", "CBr", "C#N",
    "CF", "CS", "C=C", "COC", "CC(N)",
]


def random_smiles(rng: random.Random, max_frags: int = 4) -> str:
    """A random valid molecule made by concatenating fragments."""
    n = rng.randint(1, max_frags)
    smi = "".join(rng.choice(_FRAGMENTS) for _ in range(n))
    can = chem.canonicalize(smi)
    return can if can is not None else "CCO"


def _env_hash(*vals) -> float:
    """A process-stable pseudo-shift in [0, 1)."""
    digest = hashlib.sha256("|".join(map(str, vals)).encode()).digest()
    return int.from_bytes(digest[:4], "little") % 1000 / 1000.0


def synthetic_record(rng: random.Random, sample_id: str) -> SampleRecord:
    """Deterministic pseudo-spectra derived from the molecule's structure
    (hash-based shifts)."""
    from ..chem.smiles import parse_smiles

    smi = random_smiles(rng)
    mol = parse_smiles(smi)
    h1, c13, hsqc, cosy = [], [], [], []
    for i, a in enumerate(mol.atoms):
        env = _env_hash(a.symbol, mol.degree(i), mol.total_h(i), a.aromatic)
        if a.symbol == "C":
            c_shift = 10 + env * 180
            c13.append(round(c_shift, 2))
            nh = mol.total_h(i)
            if nh:
                h_shift = 0.5 + env * 8
                h1.append([round(h_shift, 2), nh])
                hsqc.append([round(h_shift, 2), round(c_shift, 2)])
    for b in mol.bonds:
        a1, a2 = mol.atoms[b.a1], mol.atoms[b.a2]
        if a1.symbol == "C" and a2.symbol == "C" and mol.total_h(b.a1) and mol.total_h(b.a2):
            e1 = _env_hash(a1.symbol, mol.degree(b.a1), mol.total_h(b.a1), a1.aromatic)
            e2 = _env_hash(a2.symbol, mol.degree(b.a2), mol.total_h(b.a2), a2.aromatic)
            cosy.append([round(0.5 + e1 * 8, 2), round(0.5 + e2 * 8, 2)])
    ir = np.abs(np.sin(np.linspace(0, 20, 1801) * (1 + int(_env_hash(smi) * 7000) % 7)))
    return SampleRecord(sample_id, smi, h1=h1 or None, c13=c13 or None, hsqc=hsqc or None,
                        cosy=cosy or None, ir=ir)


def synthetic_dataset(n: int, seed: int = 0) -> list[SampleRecord]:
    rng = random.Random(seed)
    return [synthetic_record(rng, str(i)) for i in range(n)]


def augment_records(records: Sequence[SampleRecord], variants: int,
                    seed: int = 0) -> list[SampleRecord]:
    """Each record plus up to ``variants - 1`` randomized-SMILES copies sharing
    its spectra (the reference's SMILES augmentation made ahead of time, so
    featurization stays deterministic and the dataset can live on the
    device). Consume with ``FeaturizeOptions(use_given_smiles_form=True)``."""
    if variants <= 1:
        return list(records)
    rng = random.Random(seed)
    out: list[SampleRecord] = []
    for r in records:
        out.append(r)
        seen = {r.smiles}
        for v in range(variants - 1):
            rnd = chem.randomize(r.smiles, rng)
            if rnd is None or rnd in seen:
                continue
            seen.add(rnd)
            out.append(dataclasses.replace(r, sample_id=f"{r.sample_id}~{v + 1}", smiles=rnd))
    return out
