#!/usr/bin/env python3
"""Held-out accuracy report of the PyTorch/CUDA port: the protocol of
``scripts/accuracy_report.py`` on the card.

The held-out corpus is disjoint from the training corpus: ``random_corpus(2n,
seed=--heldout-seed)`` (within ``--mw-band lo,hi`` if given) minus every
training corpus the checkpoint saw (``--train-seed``/``--train-n``,
``--extra-exclude seed:n,...``, ``--exclude-corpus-file``), cut to its first
``n``. It is written to ``<out>/heldout_smiles.json`` with the flags that made
it and, on a later run, validated against them; a bare list there is taken as
a pinned set, unvalidated. With ``--ref-testset DIR`` the molecules and
spectra are the reference's shipped test CSVs instead (``--ref-modalities``,
``--ref-split``), minus canonical overlaps with the training corpora.

The records come from ``--records-cache`` when it exists (a ``.tar.gz`` or a
directory of reference-format CSVs, or a records pickle of either package);
else they are simulated on the device and written there: a ``.tar.gz`` or a
directory (an existing one, or a path ending in ``/``) as reference-format
CSVs, any other path as a pickle. The checkpoint ``--params`` (``--small``
for the 2+2-layer config) is evaluated chunk by chunk with the full harness
(``--fanout``-way multinomial sampling, ``--multinom-runs`` candidates, MW
filter, ``--rounds`` temperature rounds, spectral-error ranking; optionally
the ``--beam`` hypotheses, the greedy one ``--mix``, length banding
``--band-max-len``, the candidate spectra from ``--sim-weights``' shift GNN,
CLIP scores from ``--clip-params``), chunk ``ci`` seeded with ``1000 + ci``.
Each chunk is written to ``<out>/chunk_NNNN.json`` under a digest of its
molecules, the checkpoint and the decoding settings, and a later run with the
same digest reuses it. The digest's decode key ends in ``.torch``: a chunk
the JAX script wrote in the same ``--out`` is computed again, never counted
as the port's.

Writes ``ACCURACY_<tag>.json`` and ``ACCURACY_<tag>.md`` into
``--report-dir`` (the repository root by default) with the JAX report's keys
and markdown, and beside them the device (with the card's name and power
limit), each stage's seconds, how many pools hold the target and how many of
those targets have zero HSQC and COSY error, and, for a bf16 run, how many
greedy decodes differ from the float32 greedy decode of the same encodings.
Paths are relative to the working directory, the repository root. Runs on
the card unless ``--device cpu``.

    python3 scripts/torch_accuracy_report.py --params weights/mmt_r4_phase3.msgpack.gz \\
        --n 1000 --train-seed 21 --train-n 200000 --extra-exclude 11:150000 \\
        --out chiprun_out/acc --tag T --report-dir chiprun_out/acc \\
        --records-cache chiprun_out/acc/heldout_csv.tar.gz --clip-params weights/clip_r4.msgpack.gz
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KS = ("1", "3", "5", "10", "20")
# the reference's MW-banded sweeps (V100, n=1000 each): MNS and greedy exact
REF_BANDS = {
    (0, 250): {"mns": 0.911, "greedy": 0.624},
    (250, 350): {"mns": 0.483, "greedy": 0.228},
    (350, 500): {"mns": 0.166, "greedy": 0.046},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--params", default="weights/mmt_r4_phase3.msgpack.gz")
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--train-seed", type=int, default=11)
    p.add_argument("--train-n", type=int, default=50000)
    p.add_argument("--extra-exclude", default="",
                   help="further training corpora the checkpoint saw, as comma-separated "
                        "'seed:n' pairs (e.g. '11:150000')")
    p.add_argument("--exclude-corpus-file", default="",
                   help="comma-separated text files of further training SMILES to exclude exactly")
    p.add_argument("--heldout-seed", type=int, default=999)
    p.add_argument("--records-cache", default="",
                   help="held-out records: read when it exists, else simulated and written there")
    p.add_argument("--ref-testset", default="",
                   help="directory of the reference's shipped test CSVs: evaluate on those "
                        "molecules and spectra instead of simulated held-out data")
    p.add_argument("--ref-modalities", default="1h,13c,hsqc,cosy",
                   help="comma subset of 1h,13c,hsqc,cosy to load from --ref-testset")
    p.add_argument("--ref-split", default="all", choices=["all", "eval", "adapt"],
                   help="restrict --ref-testset to one half of the stable sample-id split")
    p.add_argument("--sim-weights", default="",
                   help="shift-GNN weights directory for the candidates' simulated spectra")
    p.add_argument("--chunk-size", type=int, default=48)
    p.add_argument("--fanout", type=int, default=128)
    p.add_argument("--multinom-runs", type=int, default=10)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--beam", type=int, default=0,
                   help="also pool the top-K beam hypotheses per molecule (kernel K3)")
    p.add_argument("--mix", action="store_true",
                   help="also pool the greedy hypothesis per molecule")
    p.add_argument("--clip-params", default="",
                   help="CLIP bundle: score every candidate and report top-k under the error "
                        "ranking with clip_loss folded in and under clip_loss alone")
    p.add_argument("--band-max-len", action="store_true",
                   help="decode-length banding from the target lengths (exploratory only)")
    p.add_argument("--mw-band", default="",
                   help="restrict the generated held-out corpus to one MW band 'lo,hi'")
    p.add_argument("--out", default="runs/accuracy_torch",
                   help="holds heldout_smiles.json, the chunk files and molecules.json")
    p.add_argument("--tag", default="torch")
    p.add_argument("--report-dir", default=REPO, help="where ACCURACY_<tag>.json/.md go")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 decoding and CLIP (default); --no-bf16 for float32")
    p.add_argument("--small", action="store_true", help="the 2+2-layer ModelConfig.small()")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def training_set(args) -> set:
    """Every training corpus the checkpoint saw, as the raw generated strings
    (and the lines of ``--exclude-corpus-file``)."""
    from multimodalspectraltransformer_torch.data import molrandom

    train = set(molrandom.random_corpus(args.train_n, seed=args.train_seed))
    for pair in filter(None, args.extra_exclude.split(",")):
        xseed, xn = (int(v) for v in pair.split(":"))
        train |= set(molrandom.random_corpus(xn, seed=xseed))
    for path in filter(None, args.exclude_corpus_file.split(",")):
        with open(path) as f:
            train |= {ln.strip() for ln in f if ln.strip()}
    return train


def reference_records(args) -> list:
    """The shipped test set's records: the split's half, minus the rows whose
    SMILES do not parse and canonical overlaps with the training corpora."""
    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.data import pipeline as dp

    mods = {m.strip() for m in args.ref_modalities.lower().split(",") if m.strip()}
    recs = dp.load_reference_testset(
        **{f"csv_{m}": os.path.join(args.ref_testset, name) if m in mods else ""
           for m, name in dp.REF_TESTSET_FILES.items()},
        limit=0 if args.ref_split != "all" else args.n)
    if args.ref_split != "all":
        recs = [r for r in recs if dp.ref_testset_split(r.sample_id) == args.ref_split]
        if args.n:
            recs = recs[: args.n]
    train = training_set(args)
    kept, n_unparseable = [], 0
    for r in recs:
        can = chem.canonicalize(r.smiles)
        if can is None:
            n_unparseable += 1
        elif can not in train:
            kept.append(r)
    print(f"[acc] reference test set: {len(recs)} rows, {n_unparseable} unparseable SMILES "
          f"dropped, {len(recs) - n_unparseable - len(kept)} training-corpus overlaps dropped, "
          f"{len(kept)} evaluated (modalities: {sorted(mods)})", flush=True)
    return kept


def heldout_key(args) -> dict:
    key = {"train_n": args.train_n, "train_seed": args.train_seed,
           "heldout_seed": args.heldout_seed, "n": args.n, "mw_band": args.mw_band,
           "extra_exclude": args.extra_exclude}
    if args.exclude_corpus_file:
        key["exclude_corpus_file"] = args.exclude_corpus_file
    return key


def heldout_smiles(args) -> list:
    """``<out>/heldout_smiles.json``'s molecules, validated against the
    flags; generated and written when it is absent."""
    from multimodalspectraltransformer_torch.data import molrandom

    path = os.path.join(args.out, "heldout_smiles.json")
    key = heldout_key(args)
    if os.path.exists(path):
        smiles, cached = read_heldout(path)
        if cached is None:
            print(f"[acc] using pinned held-out list {path} (legacy format, unvalidated)")
            return smiles[: args.n]
        mismatch = {k: (v, cached.get(k)) for k, v in key.items() if cached.get(k) != v}
        if mismatch:
            raise SystemExit(f"[acc] {path} was built with different corpus flags: {mismatch}; "
                             "delete it or point --out at a fresh directory")
        return smiles[: args.n]
    t0 = time.time()
    train = training_set(args)
    band = {}
    if args.mw_band:
        lo, hi = (float(x) for x in args.mw_band.split(","))
        band = {"min_mw": lo, "max_mw": hi}
    pool = molrandom.random_corpus(args.n * 2, seed=args.heldout_seed, **band)
    heldout = [s for s in pool if s not in train][: args.n]
    with open(path, "w") as f:
        json.dump({**key, "smiles": heldout}, f)
    print(f"[acc] held-out corpus: {len(heldout)} molecules ({len(pool) - len(heldout)} "
          f"overlaps/surplus dropped) in {time.time() - t0:.0f}s", flush=True)
    return heldout


def read_heldout(path: str) -> tuple:
    """(molecules, the flags they were built with) of a ``heldout_smiles.json``:
    a dict with a ``smiles`` list, or a bare list, pinned, whose flags are
    None."""
    with open(path) as f:
        cached = json.load(f)
    if isinstance(cached, list):
        return cached, None
    return cached["smiles"], cached


def load_heldout(out_dir: str, n: int) -> list:
    """The first ``n`` molecules of a pinned ``<out_dir>/heldout_smiles.json``
    (a bare list, or a dict with a ``smiles`` list), unvalidated, as
    ``scripts/torch_heldout_precision.py`` and ``chip_smoke.py`` read the
    982 pinned molecules."""
    path = os.path.join(out_dir, "heldout_smiles.json")
    if not os.path.exists(path):
        raise SystemExit(f"[acc] no pinned held-out list at {path}")
    heldout = read_heldout(path)[0][:n]
    if len(heldout) < n * 0.9:
        raise SystemExit(f"[acc] {path}: {len(heldout)} molecules, fewer than 90% of --n {n}")
    return heldout


def _as_csv_dir(path: str) -> bool:
    return path.endswith((".tar.gz", ".tgz", "/")) or os.path.isdir(path)


def load_records(path: str, scratch: str) -> list:
    """Records from a directory of reference-format CSVs, a .tar.gz of one
    (unpacked under ``scratch``, the bundle one level deep or at its top), or
    a records pickle of either package."""
    from multimodalspectraltransformer_torch.data import pipeline as dp

    if path.endswith((".tar.gz", ".tgz")):
        with tarfile.open(path) as tf:
            tf.extractall(scratch, filter="data")
        cands = [scratch] + [os.path.join(scratch, d) for d in sorted(os.listdir(scratch))]
        path = next(d for d in cands if os.path.exists(os.path.join(d, "data_1H_0.csv")))
    if os.path.isdir(path):
        return dp.load_spectra_csvs(
            csv_1h=os.path.join(path, "data_1H_0.csv"), csv_13c=os.path.join(path, "data_13C_0.csv"),
            csv_hsqc=os.path.join(path, "data_HSQC_0.csv"),
            csv_cosy=os.path.join(path, "data_COSY_0.csv"), ir_folder=os.path.join(path, "IR_data"))
    return dp.load_records_pickle(path)


def write_records(records: list, path: str) -> None:
    """``records`` as ``load_records`` reads them back from ``path``."""
    from multimodalspectraltransformer_torch.sim.factory import export_reference_csvs

    if path.endswith((".tar.gz", ".tgz")):
        tmp_dir = path + ".dir"
        export_reference_csvs(records, tmp_dir)
        with tarfile.open(path, "w:gz") as tf:
            tf.add(tmp_dir, arcname="heldout_csv")
    elif _as_csv_dir(path):
        export_reference_csvs(records, path)
    else:
        with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
            pickle.dump(records, f)


def cache_exists(path: str) -> bool:
    """A records cache to read: a file, or a directory holding a CSV bundle."""
    return os.path.isfile(path) or os.path.exists(os.path.join(path, "data_1H_0.csv"))


def device_line(dev) -> str:
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def f32_greedy_cans(records, model, max_len: int, band: bool, dev) -> list:
    """Canonical float32 greedy decodes of the records that featurize, at the
    harness's decode length."""
    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.decode import samplers
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models.mmt import MMTBatch
    from multimodalspectraltransformer_torch.utils import vocab

    feats = [f for f in (dp.featurize(r, model.cfg) for r in records) if f is not None]
    tb = dp.collate(feats)
    length = harness.banded_decode_len(tb.trg_tokens, max_len) if band else max_len
    enc = model.encode(MMTBatch(*tb.inputs).to(dev))
    res = samplers.greedy_decode(model.state_dict(), model.cfg, enc.memory,
                                 enc.memory_key_padding_mask, 1.0, length, device=dev)
    return chem.batch_canonicalize(vocab.batch_ids_to_smiles(res.tokens.cpu().numpy()))


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_key(args) -> tuple:
    """(params hash, decode key) of the chunk digests: the JAX script's, the
    decode key ending in ``.torch``."""
    params_hash = sha256_file(args.params)[:16]
    if args.beam:
        params_hash += f"+beam{args.beam}"
    if args.clip_params:
        params_hash += "+clip" + sha256_file(args.clip_params)[:8]
    decode_key = (f"f{args.fanout}.m{args.multinom_runs}.r{args.rounds}"
                  f".l{args.max_len}.b{int(args.bf16)}.x{int(args.mix)}.v2")
    if args.ref_testset:
        decode_key += f".ref[{args.ref_modalities}]"
    return params_hash, decode_key + ".torch"


def chunk_digest(smiles: list, params_hash: str, decode_key: str) -> str:
    return hashlib.sha256(("|".join(smiles) + "#" + params_hash + "#" + decode_key).encode()
                          ).hexdigest()[:16]


def evaluate_chunk(ci, chunk, digest, model, dcfg, args, clip_bundle, sim_kwargs, dev) -> dict:
    """One chunk through the harness -> its payload (the JAX script's keys,
    and the port's per-chunk counts)."""
    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.eval import harness

    t0 = time.time()
    results, summary = harness.evaluate_molecules(
        chunk, model, dcfg, seed=1000 + ci, simulate_errors=True, sim_kwargs=sim_kwargs,
        clip_bundle=clip_bundle, clip_block=dcfg.multinom_runs if clip_bundle else 0, device=dev)
    wall = time.time() - t0
    hits, topk_n = harness.top_k_hits(results)
    top_k_hits = {str(k): v for k, v in hits.items()}
    payload: dict = {}
    if clip_bundle is not None:
        h3, n3 = harness.top_k_hits(results, keys=("hsqc_error", "cosy_error", "clip_loss"))
        hc, ncx = harness.top_k_hits(results, keys=("clip_loss",))
        if n3 != topk_n or ncx != topk_n:
            raise AssertionError(f"chunk {ci}: the CLIP rankings see other pools")
        bad = [c.smiles for r in results for c in r.candidates
               if not (np.isfinite(c.clip_loss) and np.isfinite(c.clip_dot))]
        if bad:
            raise AssertionError(f"chunk {ci}: {len(bad)} candidates without CLIP scores")
        payload["top_k_hits_clip"] = {str(k): v for k, v in h3.items()}
        payload["top_k_hits_cliponly"] = {str(k): v for k, v in hc.items()}
    in_pool = [c for r in results for c in r.candidates if c.exact]
    port = {"stage_seconds": summary.stage_seconds, "target_in_pool": len(in_pool),
            "target_zero_error": sum(c.hsqc_error == 0.0 and c.cosy_error == 0.0 for c in in_pool)}
    if args.bf16:
        f32 = f32_greedy_cans(chunk, model, args.max_len, args.band_max_len, dev)
        port["greedy_bf16_differs"] = sum(chem.batch_canonicalize([r.greedy])[0] != can
                                          for r, can in zip(results, f32))
        port["greedy_f32_exact"] = sum(can is not None and can == chem.canonicalize(r.target)
                                       for r, can in zip(results, f32))
    payload.update({
        "chunk": ci, "digest": digest, "wall_s": wall,
        "top_k": {k: (v / topk_n if topk_n else 0.0) for k, v in top_k_hits.items()},
        "top_k_hits": top_k_hits, "top_k_n": topk_n,
        "molecules": [{"target": r.target, "greedy": r.greedy, "greedy_exact": r.greedy_exact,
                       "greedy_tanimoto": r.greedy_tanimoto, "mns_exact": r.mns_exact,
                       "best_tanimoto": r.best_tanimoto,
                       "corr_sampling_prob": r.corr_sampling_prob,
                       "n_candidates": len(r.candidates), "rounds": r.sampling_rounds}
                      for r in results],
        "port": port,
    })
    print(f"[acc] chunk {ci + 1}: {len(results)} mols {wall:.1f}s | greedy "
          f"{summary.greedy_exact:.3f} mns {summary.mns_exact:.3f} tani "
          f"{summary.greedy_tanimoto:.3f}", flush=True)
    return payload


def chunk_counts(prev: dict) -> tuple:
    """(top-k hits, denominator) of a chunk file; a legacy chunk without
    ``top_k_hits`` rebuilds them from its fractions over the molecules with
    candidates."""
    if "top_k_hits" in prev:
        return prev["top_k_hits"], prev["top_k_n"]
    n_leg = sum(1 for m in prev["molecules"] if m["n_candidates"])
    return {k: round(v * n_leg) for k, v in prev.get("top_k", {}).items()}, n_leg


def pooled(rows: list, total: int) -> dict:
    """sum(hits) / sum(denominators) over the chunks, per k."""
    return {k: sum(h.get(k, 0) for h in rows) / total for k in KS} if total else {}


def run(args) -> dict:
    """Make the report; returns {"report": the dict written, "records": the
    records evaluated, "chunks": the chunk payloads, "seconds": the host
    seconds of the held-out list, the records and the chunk loop}."""
    import torch

    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.rank import clip
    from multimodalspectraltransformer_torch.sim import distill, factory
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = device_line(dev)
    print(f"[acc] device: {card}", flush=True)

    t_heldout = time.time()
    ref_records = reference_records(args) if args.ref_testset else None
    if ref_records is not None:
        heldout = [r.smiles for r in ref_records]
        args.n = min(args.n, len(heldout))  # a --ref-split half holds ~500 molecules
    else:
        heldout = heldout_smiles(args)
    if len(heldout) < args.n * 0.9:
        raise SystemExit(f"[acc] too few held-out molecules: {len(heldout)} of --n {args.n}")
    t_heldout = time.time() - t_heldout

    mcfg = ModelConfig.small() if args.small else ModelConfig()
    model = mmt.load_model(args.params, mcfg, device=dev)
    clip_bundle = None
    if args.clip_params:
        clip_bundle = clip.load_bundle(args.clip_params, device=dev)
        print(f"[acc] trained CLIP ranker loaded from {args.clip_params}", flush=True)
    sim_kwargs = None
    if args.sim_weights:
        alt = distill.load_shift_weights(args.sim_weights, dev)
        if alt is None:
            raise SystemExit(f"--sim-weights {args.sim_weights}: no weights found")
        sim_kwargs = {"shift_model": alt[0], "stats": alt[1]}
        print(f"[acc] candidate simulation uses shift weights from {args.sim_weights}", flush=True)
    dcfg = DecodeConfig(max_len=args.max_len, fanout=args.fanout, multinom_runs=args.multinom_runs,
                        max_temp_rounds=args.rounds, mw_filter=True,
                        compute_dtype="bfloat16" if args.bf16 else None,
                        beam_candidates=args.beam, greedy_in_pool=args.mix,
                        band_max_len=args.band_max_len)

    t0 = time.time()
    if ref_records is not None:
        records = ref_records  # the shipped spectra as they are
    elif args.records_cache and cache_exists(args.records_cache):
        with tempfile.TemporaryDirectory(dir=args.out) as scratch:
            records = load_records(args.records_cache, scratch)
        keep = set(heldout)
        records = [r for r in records if r.smiles in keep][: args.n]
        print(f"[acc] loaded {len(records)} cached records", flush=True)
    else:
        records = factory.simulate_records(heldout, device=dev)
        if args.records_cache:
            write_records(records, args.records_cache)
    t_records = time.time() - t0
    print(f"[acc] records ready: {len(records)} in {t_records:.0f}s", flush=True)

    params_hash, decode_key = run_key(args)
    chunks = [records[i : i + args.chunk_size] for i in range(0, len(records), args.chunk_size)]
    payloads = []
    t_all = time.time()
    for ci, chunk in enumerate(chunks):
        path = os.path.join(args.out, f"chunk_{ci:04d}.json")
        digest = chunk_digest([r.smiles for r in chunk], params_hash, decode_key)
        if os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if prev.get("digest") == digest:
                payloads.append(prev)
                continue
        payload = evaluate_chunk(ci, chunk, digest, model, dcfg, args, clip_bundle, sim_kwargs, dev)
        with open(path, "w") as f:
            json.dump(payload, f)
        payloads.append(payload)
    wall_total = time.time() - t_all

    mols = [m for p in payloads for m in p["molecules"]]
    n = len(mols)

    def mean(key: str, sel: list = mols) -> float:
        return sum(float(m[key]) for m in sel) / max(len(sel), 1)

    bands = {}
    for (lo, hi), ref in REF_BANDS.items():
        sel = [m for m in mols if lo <= chem.mol_wt(m["target"]) < hi]
        if sel:
            bands[f"{lo}-{hi}"] = {
                "n": len(sel), "mns_exact": mean("mns_exact", sel),
                "greedy_exact": mean("greedy_exact", sel), "best_tanimoto": mean("best_tanimoto", sel),
                "greedy_tanimoto": mean("greedy_tanimoto", sel),
                "reference_mns_exact": ref["mns"], "reference_greedy_exact": ref["greedy"]}
    counts = [chunk_counts(p) for p in payloads]
    total_topk_n = sum(c for _, c in counts)
    top_k = pooled([h for h, _ in counts], total_topk_n)
    clip_rows = [p for p in payloads if "top_k_hits_clip" in p]
    clip_n = sum(p["top_k_n"] for p in clip_rows)
    top_k_clip = pooled([p["top_k_hits_clip"] for p in clip_rows], clip_n)
    top_k_cliponly = pooled([p["top_k_hits_cliponly"] for p in clip_rows], clip_n)
    ports = [p.get("port", {}) for p in payloads]
    stages: dict = {}
    for pt in ports:
        for k, v in pt.get("stage_seconds", {}).items():
            stages[k] = stages.get(k, 0.0) + v
    n_in_pool = sum(pt.get("target_in_pool", 0) for pt in ports)
    n_zero_error = sum(pt.get("target_zero_error", 0) for pt in ports)
    report = {
        "tag": args.tag, "n": n,
        "greedy_exact": mean("greedy_exact"), "greedy_tanimoto": mean("greedy_tanimoto"),
        "mns_exact": mean("mns_exact"), "best_tanimoto": mean("best_tanimoto"),
        "corr_sampling_prob": mean("corr_sampling_prob"),
        "top_k_by_error": top_k, "top_k_n": total_topk_n,
        **({"top_k_by_error_plus_clip": top_k_clip, "top_k_by_clip_only": top_k_cliponly,
            "clip_params": args.clip_params} if top_k_clip else {}),
        "mw_bands": bands, "wall_s_total": wall_total, "params": args.params,
        "fanout": args.fanout, "multinom_runs": args.multinom_runs,
        "beam_candidates": args.beam, "greedy_in_pool": args.mix,
        "heldout_seed": args.heldout_seed, "ref_testset": args.ref_testset,
        "ref_modalities": args.ref_modalities if args.ref_testset else "",
        "ref_split": args.ref_split if args.ref_testset else "",
        "sim_weights": args.sim_weights,
        "reference": {"zinc_0_250_mns_exact": 0.911, "zinc_0_250_greedy_exact": 0.624,
                      "source": "scripts/ZINC_0_250.txt (V100, n=1000)"},
        # the port's additions
        "stage_seconds": stages, "target_in_pool": n_in_pool, "target_zero_error": n_zero_error,
        **({"greedy_f32_exact": sum(pt.get("greedy_f32_exact", 0) for pt in ports) / max(n, 1),
            "greedy_bf16_differs_from_f32": sum(pt.get("greedy_bf16_differs", 0) for pt in ports)}
           if args.bf16 else {}),
        "records_cache": args.records_cache,
        "heldout": "" if args.ref_testset else os.path.join(args.out, "heldout_smiles.json"),
        "max_temp_rounds": args.rounds, "max_len": args.max_len, "bf16": args.bf16,
        "band_max_len": args.band_max_len, "small": args.small, "device": card,
        "torch": torch.__version__,
    }
    os.makedirs(args.report_dir, exist_ok=True)
    with open(os.path.join(args.out, "molecules.json"), "w") as f:
        json.dump(mols, f)
    with open(os.path.join(args.report_dir, f"ACCURACY_{args.tag}.json"), "w") as f:
        json.dump(report, f, indent=1)
    with open(os.path.join(args.report_dir, f"ACCURACY_{args.tag}.md"), "w") as f:
        f.write("\n".join(markdown(args, report)) + "\n")
    print(json.dumps(report, indent=1))
    return {"report": report, "records": records, "chunks": payloads,
            "seconds": {"heldout": t_heldout, "records": t_records, "chunks": wall_total}}


def markdown(args, report: dict) -> list:
    """The JAX report's markdown, then the port's rows."""
    n, top_k = report["n"], report["top_k_by_error"]
    if args.ref_testset:
        provenance = [
            "**The reference's own shipped test set**: 1000 ZINC molecules",
            "(250-350 Da) with SGNN-simulated spectra from",
            "`MMT_website/Runfolder/CSV_files/` — spectra generated by the",
            f"REFERENCE's simulator, not ours. Modalities: {args.ref_modalities}",
            f"(no IR exists in the set). n = {n} evaluated.",
        ]
        cmp_name, cmp_mns, cmp_greedy = "reference (PubChem 250-350, V100)", 0.483, 0.228
    else:
        provenance = [
            f"Held-out factory molecules (seed {args.heldout_seed}, disjoint from the",
            f"training corpus by canonical SMILES), n = {n}.",
        ]
        cmp_name, cmp_mns, cmp_greedy = "reference (ZINC 0-250, V100)", 0.911, 0.624
    dash = args.ref_testset
    md = [
        f"# Accuracy report ({args.tag})", "", *provenance,
        f"Harness: {args.fanout}-way",
        f"fan-out MNS, {args.multinom_runs} candidates, MW filter, temperature",
        "escalation, trained-GNN spectral simulation, device spectral-error ranking.", "",
        f"| metric | value | {cmp_name} |", "|---|---|---|",
        f"| MNS top-rank exact recovery | **{report['mns_exact']:.3f}** | {cmp_mns} |",
        f"| greedy exact recovery | **{report['greedy_exact']:.3f}** | {cmp_greedy} |",
        f"| greedy tanimoto (mean) | {report['greedy_tanimoto']:.3f} | {'-' if dash else 0.842} |",
        f"| best-candidate tanimoto (mean) | {report['best_tanimoto']:.3f} | {'-' if dash else 0.967} |",
        f"| teacher-forced P(sequence) | {report['corr_sampling_prob']:.3f} | - |",
    ]
    total = report["top_k_n"]
    for k, v in top_k.items():
        md.append(f"| top-{k} by spectral-error rank | {v:.3f} "
                  f"(n={total}; over all {n}: {v * total / max(n, 1):.3f}) | - |")
    if "top_k_by_error_plus_clip" in report:
        md += ["", "## CLIP re-ranking (trained ranker: `" + args.clip_params + "`)", "",
               "Same candidate pools, three rankings — the delta vs the protocol",
               "error-rank table above is what the trained CLIP ranker buys:", "",
               "| k | error ranks only (protocol) | error + CLIP rank avg | CLIP rank only |",
               "|---|---|---|---|"]
        md += [f"| {k} | {top_k.get(k, 0.0):.3f} | {report['top_k_by_error_plus_clip'][k]:.3f} "
               f"| {report['top_k_by_clip_only'][k]:.3f} |" for k in KS]
    if report["mw_bands"]:
        md += ["", "## By molecular-weight band", "",
               "The reference's sweeps are stratified by MW (ZINC 0-250,",
               "PubChem 250-350 / 350-500); its recovery drops steeply with size,",
               "so the banded rows are the like-for-like comparison:", "",
               "| band (Da) | n | MNS exact | ref | greedy exact | ref | best tanimoto |",
               "|---|---|---|---|---|---|---|"]
        md += [f"| {name} | {b['n']} | **{b['mns_exact']:.3f}** | {b['reference_mns_exact']} "
               f"| {b['greedy_exact']:.3f} | {b['reference_greedy_exact']} | {b['best_tanimoto']:.3f} |"
               for name, b in report["mw_bands"].items()]
    if args.ref_testset:
        tail = [
            "This is the LIKE-FOR-LIKE external benchmark: the query spectra were",
            "simulated by the reference's own SGNN pipeline (shipped in its repo),",
            "so the model is inverting a simulator it never trained on. The",
            "closest reference bar is its 250-350 Da sweep (MNS 0.483, greedy",
            "0.228 — PubChem molecules, SGNN spectra, `scripts/PC_250_350.txt`);",
            "this set is ZINC molecules of the same MW band. Candidate spectral-",
            "error ranking still uses OUR factory simulator for candidate spectra",
            "(the reference re-runs SGNN), so top-k-by-error carries a",
            "simulator-mismatch penalty the reference's own runs don't have.",
        ]
    else:
        tail = [
            "The reference numbers are its own simulated-data regime (SGNN-trained",
            "spectra of ZINC molecules); ours is the equivalent closed loop on the",
            "first-party factory (rule-teacher-distilled GNN spectra of generated",
            "drug-like molecules). Both measure the same thing: can the model invert",
            "its own simulator's spectra back to the structure.",
        ]
    ckpt_line = args.params
    if args.params.startswith(("/tmp", ".cache")):
        ckpt_line = (f"{args.params} (EPHEMERAL — export to weights/ with "
                     "train.checkpoint.export_params_msgpack and commit it; this "
                     "report is not reproducible until that file is in git)")
    md += ["", f"Checkpoint: `{ckpt_line}`. Reproduce: see this script's docstring.", "", *tail]
    md += ["", "## The PyTorch port", "",
           f"`scripts/torch_accuracy_report.py` on `{report['device']}` (torch {report['torch']}), "
           f"{'bf16' if args.bf16 else 'float32'} decoding, length {args.max_len}, "
           f"{args.rounds} temperature rounds; records "
           f"`{args.records_cache or ('the shipped CSVs' if dash else 'simulated on the device')}`; "
           f"{report['wall_s_total']:.1f} s in all.", "",
           "| metric | value |", "|---|---|"]
    if args.bf16:
        md.append(f"| greedy exact, float32 decode | {report['greedy_f32_exact']:.3f} "
                  f"({report['greedy_bf16_differs_from_f32']} bf16 decodes differ) |")
    md.append(f"| pools holding the target; of them with zero HSQC and COSY error | "
              f"{report['target_in_pool']}; {report['target_zero_error']} |")
    md += [f"| {k} seconds | {v:.3f} |" for k, v in report["stage_seconds"].items()]
    return md


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
