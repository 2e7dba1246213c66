#!/usr/bin/env python3
"""Held-out accuracy report of the PyTorch/CUDA port on pinned records.

The port's counterpart of ``scripts/accuracy_report.py``, with the options
its committed CLIP result (``ACCURACY_r05clip.json``) used: the pinned
held-out SMILES list ``<out>/heldout_smiles.json`` (a bare list, or a dict
with a ``smiles`` list), the pinned simulated records ``--records-cache`` (a
``.tar.gz`` or a directory of reference-format CSVs), the MMT checkpoint
``--params``, optionally the CLIP bundle ``--clip-params``, and the harness
settings (128-way fan-out, 10 candidates, 10 temperature rounds, length 64,
bf16 decoding), evaluated in chunks of 48 molecules (seed 1000 + chunk).
Paths are relative to the working directory, the repository root.

Writes ``ACCURACY_<tag>.json`` and ``ACCURACY_<tag>.md`` into
``--report-dir`` (the repository root by default) with the JAX report's keys:
greedy and MNS exact recovery, top-k by spectral error, by error plus CLIP
and by CLIP alone over the molecules with a rankable pool, the MW bands and
the wall time; beside them the device (with the card's name and power limit)
and, for a bf16 run, how many greedy decodes differ from the float32 greedy
decode of the same encodings (the float32 decode is token-identical to the
JAX package's, tests/test_torch_decode.py), and how many pools hold the
target and how many of those targets have zero HSQC and COSY error (their
simulated spectra are the query's).

    mkdir -p chiprun_out/acc && cp runs/accuracy_r3/heldout_smiles.json chiprun_out/acc/
    python3 scripts/torch_accuracy_report.py --n 982 --out chiprun_out/acc --tag torch_r05clip \\
        --records-cache runs/accuracy_r2b/heldout_csv.tar.gz \\
        --clip-params weights/clip_r4.msgpack.gz
"""

from __future__ import annotations

import argparse
import json
import os
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
    p.add_argument("--clip-params", default="",
                   help="CLIP bundle: score every candidate and report top-k under the error "
                        "ranking with clip_loss folded in and under clip_loss alone")
    p.add_argument("--records-cache", required=True,
                   help="pinned records: a .tar.gz or a directory of reference-format CSVs")
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--chunk-size", type=int, default=48)
    p.add_argument("--fanout", type=int, default=128)
    p.add_argument("--multinom-runs", type=int, default=10)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 decoding and CLIP (default); --no-bf16 for float32")
    p.add_argument("--out", default="runs/accuracy_torch",
                   help="holds heldout_smiles.json (read) and molecules.json (written)")
    p.add_argument("--tag", default="torch")
    p.add_argument("--report-dir", default=REPO, help="where ACCURACY_<tag>.json/.md go")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_heldout(out_dir: str, n: int) -> list[str]:
    """The pinned held-out list, read as the JAX script reads it."""
    path = os.path.join(out_dir, "heldout_smiles.json")
    if not os.path.exists(path):
        raise SystemExit(f"[acc] no pinned held-out list at {path}")
    with open(path) as f:
        cached = json.load(f)
    heldout = (cached if isinstance(cached, list) else cached["smiles"])[:n]
    if len(heldout) < n * 0.9:
        raise SystemExit(f"[acc] {path}: {len(heldout)} molecules, fewer than 90% of --n {n}")
    return heldout


def load_records(path: str, scratch: str):
    """Records from a directory of reference-format CSVs or a .tar.gz of one
    (unpacked under ``scratch``)."""
    from multimodalspectraltransformer_torch.data import pipeline as dp

    if path.endswith((".tar.gz", ".tgz")):
        with tarfile.open(path) as tf:
            tf.extractall(scratch, filter="data")
        cands = [scratch] + [os.path.join(scratch, d) for d in sorted(os.listdir(scratch))]
        path = next(d for d in cands if os.path.exists(os.path.join(d, "data_1H_0.csv")))
    return dp.load_spectra_csvs(
        csv_1h=os.path.join(path, "data_1H_0.csv"), csv_13c=os.path.join(path, "data_13C_0.csv"),
        csv_hsqc=os.path.join(path, "data_HSQC_0.csv"), csv_cosy=os.path.join(path, "data_COSY_0.csv"),
        ir_folder=os.path.join(path, "IR_data"))


def device_line(dev) -> str:
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def f32_greedy_cans(records, model, max_len: int, dev) -> list:
    """Canonical float32 greedy decodes of the records that featurize."""
    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.decode import samplers
    from multimodalspectraltransformer_torch.models.mmt import MMTBatch
    from multimodalspectraltransformer_torch.utils import vocab

    feats = [f for f in (dp.featurize(r, model.cfg) for r in records) if f is not None]
    enc = model.encode(MMTBatch(*dp.collate(feats).inputs).to(dev))
    res = samplers.greedy_decode(model.state_dict(), model.cfg, enc.memory,
                                 enc.memory_key_padding_mask, 1.0, max_len, device=dev)
    return chem.batch_canonicalize(vocab.batch_ids_to_smiles(res.tokens.cpu().numpy()))


def pooled(hits_n: list) -> dict:
    """sum(hits) / sum(denominators) over the chunks, per k."""
    total = sum(n for _, n in hits_n)
    return {k: sum(h[int(k)] for h, _ in hits_n) / total for k in KS} if total else {}


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    import torch

    from multimodalspectraltransformer_torch.chem import api as chem
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.rank import clip
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig
    from multimodalspectraltransformer_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = device_line(dev)
    print(f"[acc] device: {card}", flush=True)

    heldout = load_heldout(args.out, args.n)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=args.out) as scratch:
        records = load_records(args.records_cache, scratch)
    keep = set(heldout)
    records = [r for r in records if r.smiles in keep][: args.n]
    print(f"[acc] {len(records)} pinned records of {len(heldout)} held-out molecules loaded in "
          f"{time.time() - t0:.1f} s", flush=True)

    model = mmt.load_model(args.params, ModelConfig(), device=dev)
    clip_bundle = clip.load_bundle(args.clip_params, device=dev) if args.clip_params else None
    dcfg = DecodeConfig(max_len=args.max_len, fanout=args.fanout, multinom_runs=args.multinom_runs,
                        max_temp_rounds=args.rounds, mw_filter=True,
                        compute_dtype="bfloat16" if args.bf16 else None)

    chunks = [records[i : i + args.chunk_size] for i in range(0, len(records), args.chunk_size)]
    mols, by_error, by_clip, clip_only = [], [], [], []
    stages: dict[str, float] = {}
    n_greedy_differs = n_f32_exact = n_target_in_pool = n_target_zero_error = 0
    t_all = time.time()
    for ci, chunk in enumerate(chunks):
        t0 = time.time()
        results, summary = harness.evaluate_molecules(
            chunk, model, dcfg, seed=1000 + ci, simulate_errors=True, clip_bundle=clip_bundle,
            clip_block=dcfg.multinom_runs if clip_bundle else 0, device=dev)
        wall = time.time() - t0
        for k, v in summary.stage_seconds.items():
            stages[k] = stages.get(k, 0.0) + v
        hits, n = harness.top_k_hits(results)
        by_error.append((hits, n))
        if clip_bundle is not None:
            for keys, acc in ((("hsqc_error", "cosy_error", "clip_loss"), by_clip),
                              (("clip_loss",), clip_only)):
                h, n_k = harness.top_k_hits(results, keys=keys)
                assert n_k == n  # same pools, same filter
                acc.append((h, n_k))
            bad = [c.smiles for r in results for c in r.candidates
                   if not (np.isfinite(c.clip_loss) and np.isfinite(c.clip_dot))]
            if bad:
                raise AssertionError(f"chunk {ci}: {len(bad)} candidates without CLIP scores")
        for r in results:
            for c in r.candidates:
                if c.exact:
                    n_target_in_pool += 1
                    n_target_zero_error += c.hsqc_error == 0.0 and c.cosy_error == 0.0
        if args.bf16:
            f32 = f32_greedy_cans(chunk, model, args.max_len, dev)
            for r, can in zip(results, f32):
                n_greedy_differs += chem.batch_canonicalize([r.greedy])[0] != can
                n_f32_exact += can is not None and can == chem.canonicalize(r.target)
        mols += [{"target": r.target, "greedy": r.greedy, "greedy_exact": r.greedy_exact,
                  "greedy_tanimoto": r.greedy_tanimoto, "mns_exact": r.mns_exact,
                  "best_tanimoto": r.best_tanimoto, "corr_sampling_prob": r.corr_sampling_prob,
                  "n_candidates": len(r.candidates), "rounds": r.sampling_rounds}
                 for r in results]
        print(f"[acc] chunk {ci + 1}/{len(chunks)}: {len(results)} mols {wall:.1f} s | greedy "
              f"{summary.greedy_exact:.3f} mns {summary.mns_exact:.3f} top-1 "
              f"{summary.top_k_accuracy[1]:.3f}", flush=True)
    wall_total = time.time() - t_all

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
    top_k = pooled(by_error)
    report = {
        "tag": args.tag, "n": n,
        "greedy_exact": mean("greedy_exact"), "greedy_tanimoto": mean("greedy_tanimoto"),
        "mns_exact": mean("mns_exact"), "best_tanimoto": mean("best_tanimoto"),
        "corr_sampling_prob": mean("corr_sampling_prob"),
        "top_k_by_error": top_k, "top_k_n": sum(c for _, c in by_error),
        **({"top_k_by_error_plus_clip": pooled(by_clip), "top_k_by_clip_only": pooled(clip_only),
            "clip_params": args.clip_params} if clip_bundle is not None else {}),
        "mw_bands": bands, "wall_s_total": wall_total, "stage_seconds": stages,
        "target_in_pool": n_target_in_pool, "target_zero_error": n_target_zero_error,
        **({"greedy_f32_exact": n_f32_exact / max(n, 1),
            "greedy_bf16_differs_from_f32": n_greedy_differs} if args.bf16 else {}),
        "params": args.params, "records_cache": args.records_cache,
        "heldout": os.path.join(args.out, "heldout_smiles.json"), "fanout": args.fanout,
        "multinom_runs": args.multinom_runs, "max_temp_rounds": args.rounds, "max_len": args.max_len,
        "bf16": args.bf16, "beam_candidates": 0, "greedy_in_pool": False,
        "device": card, "torch": torch.__version__,
    }
    os.makedirs(args.report_dir, exist_ok=True)
    with open(os.path.join(args.out, "molecules.json"), "w") as f:
        json.dump(mols, f)
    with open(os.path.join(args.report_dir, f"ACCURACY_{args.tag}.json"), "w") as f:
        json.dump(report, f, indent=1)

    md = [f"# Accuracy report ({args.tag}): the PyTorch port", "",
          f"Pinned held-out records (`{args.records_cache}`, filtered to "
          f"`{report['heldout']}`), n = {n}; device `{card}`; checkpoint `{args.params}`.",
          f"Harness: {args.fanout}-way fan-out MNS, {args.multinom_runs} candidates, MW filter, "
          f"{args.rounds} temperature rounds, length {args.max_len}, "
          f"{'bf16' if args.bf16 else 'float32'}; {wall_total:.1f} s in all.", "",
          "| metric | value |", "|---|---|",
          f"| MNS top-rank exact recovery | **{report['mns_exact']:.3f}** |",
          f"| greedy exact recovery | **{report['greedy_exact']:.3f}** |",
          f"| greedy tanimoto (mean) | {report['greedy_tanimoto']:.3f} |",
          f"| best-candidate tanimoto (mean) | {report['best_tanimoto']:.3f} |",
          f"| teacher-forced P(sequence) | {report['corr_sampling_prob']:.3f} |"]
    if args.bf16:
        md.append(f"| greedy exact, float32 decode | {report['greedy_f32_exact']:.3f} "
                  f"({n_greedy_differs} bf16 decodes differ) |")
    md += [f"| top-{k} by spectral-error rank | {v:.3f} (n={report['top_k_n']}) |"
           for k, v in top_k.items()]
    md.append(f"| pools holding the target; of them with zero HSQC and COSY error | "
              f"{n_target_in_pool}; {n_target_zero_error} |")
    if clip_bundle is not None:
        md += ["", f"## CLIP re-ranking (`{args.clip_params}`)", "",
               "| k | error ranks only | error + CLIP rank avg | CLIP rank only |", "|---|---|---|---|"]
        md += [f"| {k} | {top_k[k]:.3f} | {report['top_k_by_error_plus_clip'][k]:.3f} | "
               f"{report['top_k_by_clip_only'][k]:.3f} |" for k in KS]
    if bands:
        md += ["", "## By molecular-weight band", "",
               "| band (Da) | n | MNS exact | ref | greedy exact | ref | best tanimoto |",
               "|---|---|---|---|---|---|---|"]
        md += [f"| {name} | {b['n']} | **{b['mns_exact']:.3f}** | {b['reference_mns_exact']} | "
               f"{b['greedy_exact']:.3f} | {b['reference_greedy_exact']} | {b['best_tanimoto']:.3f} |"
               for name, b in bands.items()]
    with open(os.path.join(args.report_dir, f"ACCURACY_{args.tag}.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
