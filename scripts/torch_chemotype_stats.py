#!/usr/bin/env python3
"""Quantify the chemotype gap between the reference's test molecules and a
training corpus.

The port's counterpart of ``scripts/chemotype_stats.py``, whose docstring
gives the reasons: structural statistics (heavy atoms, weight, token length,
aromatic, ring and hetero fractions, ring systems and fused systems, N/O/S
and halogen counts, rotatable bonds, stereo marks; mean / median of each) of
the ADAPT halves of the shipped test sets in ``--ref-dir`` against a sample
of ``--sample`` molecules of ``--corpus`` (and of ``--extra``), drawn by
``random.Random(7)``, through the port's ``chem/`` and tokenizer; then the
test set's tokens that the corpus under-represents. The same inputs print
the JAX script's table, byte for byte. Host only.

    python3 scripts/torch_chemotype_stats.py --corpus corpus_r3_300k.txt --ref-dir DIR \\
        [--extra corpus_zinclike.txt]
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.chem import properties  # noqa: E402
from multimodalspectraltransformer_torch.chem import smiles as chem_smiles  # noqa: E402
from multimodalspectraltransformer_torch.chem.tokenizer import tokenize_smiles as tokenize  # noqa: E402
from multimodalspectraltransformer_torch.data.pipeline import (  # noqa: E402
    REF_TESTSET_DIR,
    load_reference_sets,
    ref_testset_split,
)


def ring_systems(mol) -> list[set[int]]:
    """Connected components of ring atoms (fused systems count once)."""
    ring_atoms = {i for i, a in enumerate(mol.atoms) if getattr(a, "in_ring", False)}
    # fall back to bond ring marks
    if not ring_atoms:
        for b in mol.bonds:
            if getattr(b, "in_ring", False):
                ring_atoms.add(b.a1)
                ring_atoms.add(b.a2)
    seen: set[int] = set()
    comps = []
    for start in ring_atoms:
        if start in seen:
            continue
        comp = {start}
        stack = [start]
        while stack:
            i = stack.pop()
            for j in mol.neighbors(i):
                if j in ring_atoms and j not in comp:
                    b = mol.bond_between(i, j)
                    if b is not None and getattr(b, "in_ring", False):
                        comp.add(j)
                        stack.append(j)
        seen |= comp
        comps.append(comp)
    return comps


def stats(smiles_list: list[str], name: str) -> dict:
    rows = []
    tok_counter: Counter = Counter()
    for s in smiles_list:
        try:
            m = chem_smiles.parse_smiles(s)
        except Exception:  # the JAX script skips whatever its parser refuses
            continue
        n = m.num_atoms
        arom = sum(1 for a in m.atoms if a.aromatic)
        ring_bonds = [b for b in m.bonds if getattr(b, "in_ring", False)]
        ring_atoms = {x for b in ring_bonds for x in (b.a1, b.a2)}
        systems = ring_systems(m)
        fused = sum(1 for c in systems if len(c) > 6)
        hetero = sum(1 for a in m.atoms if a.symbol not in ("C", "H"))
        nN = sum(1 for a in m.atoms if a.symbol == "N")
        nO = sum(1 for a in m.atoms if a.symbol == "O")
        nS = sum(1 for a in m.atoms if a.symbol == "S")
        nHal = sum(1 for a in m.atoms if a.symbol in ("F", "Cl", "Br", "I"))
        # rotatable-ish: acyclic single bonds between two heavy-degree>1 atoms
        rot = 0
        for b in m.bonds:
            if getattr(b, "in_ring", False) or b.order != 1 or b.aromatic:
                continue
            if m.degree(b.a1) > 1 and m.degree(b.a2) > 1:
                rot += 1
        toks = tokenize(s)
        tok_counter.update(toks)
        rows.append(dict(
            natoms=n, wt=properties.mol_wt(m),
            ntok=len(toks),
            arom_frac=arom / max(n, 1),
            ring_frac=len(ring_atoms) / max(n, 1),
            n_ring_systems=len(systems), n_fused=fused,
            hetero_frac=hetero / max(n, 1),
            nN=nN, nO=nO, nS=nS, nHal=nHal, rot=rot,
            stereo=s.count("@"),
        ))
    out = {"name": name, "n": len(rows)}
    for k in rows[0]:
        v = np.array([r[k] for r in rows], dtype=np.float64)
        out[k] = (round(float(v.mean()), 3), round(float(np.percentile(v, 50)), 3))
    out["_tokens"] = tok_counter
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", default="/tmp/corpus_r3_300k.txt")
    ap.add_argument("--sample", type=int, default=3000)
    ap.add_argument("--extra", default="", help="extra SMILES file to compare")
    ap.add_argument("--ref-dir", default=REF_TESTSET_DIR)
    args = ap.parse_args(argv)

    recs, recs1h = load_reference_sets(args.ref_dir)
    zinc_adapt = [r.smiles for r in recs if ref_testset_split(r.sample_id) == "adapt"]
    zinc1h_adapt = [r.smiles for r in recs1h if ref_testset_split(r.sample_id) == "adapt"]

    rng = random.Random(7)
    with open(args.corpus) as f:
        corpus = [ln.strip() for ln in f if ln.strip()]
    corpus_s = rng.sample(corpus, min(args.sample, len(corpus)))

    groups = [stats(zinc_adapt + zinc1h_adapt, "zinc_adapt"),
              stats(corpus_s, "molrandom")]
    if args.extra:
        with open(args.extra) as f:
            extra = [ln.strip() for ln in f if ln.strip()]
        groups.append(stats(rng.sample(extra, min(args.sample, len(extra))),
                            os.path.basename(args.extra)))

    keys = [k for k in groups[0] if not k.startswith("_") and k not in ("name", "n")]
    hdr = f"{'stat':>16}" + "".join(f"{g['name']:>24}" for g in groups)
    print(hdr)
    print(f"{'n':>16}" + "".join(f"{g['n']:>24}" for g in groups))
    for k in keys:
        print(f"{k:>16}" + "".join(
            f"{str(g[k][0]) + ' / ' + str(g[k][1]):>24}" for g in groups))

    # token coverage: test-set tokens missing or rare in the corpus
    zt = groups[0]["_tokens"]
    ct = groups[1]["_tokens"]
    ztot = sum(zt.values())
    ctot = sum(ct.values())
    print("\nZINC tokens under-represented in molrandom (freq ratio < 0.3):")
    for tok, cnt in zt.most_common():
        zf = cnt / ztot
        cf = ct.get(tok, 0) / ctot
        if zf > 1e-4 and (cf == 0 or cf / zf < 0.3):
            print(f"  {tok!r}: zinc {zf:.5f} vs corpus {cf:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
