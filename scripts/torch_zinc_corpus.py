#!/usr/bin/env python3
"""Generate a ZINC-chemotype training corpus by fragment recombination.

The port's counterpart of ``scripts/zinc_corpus.py``, whose docstring gives
the reasons. BRICS-style fragment recombination seeded from the ADAPT halves
of the shipped test sets in ``--ref-dir`` only (the EVAL half contributes
nothing, and its canonical SMILES are excluded from the output):

1. Canonicalize adapt-half molecules (the canonical form is stereo-free).
2. Cut every acyclic, non-aromatic single bond with at least 2 atoms on each
   side (``fragment_molecule``); the fragments (rings and linkers, with their
   attachment sites) form the library.
3. Join random fragments at attachment sites with single bonds
   (``assemble``; hetero-hetero joins refused), capping leftover sites with
   implicit H; keep an assembly that canonicalizes, lies in ``[--mw-lo,
   --mw-hi]`` Da and is new.
4. A ``--mutate`` fraction of outputs takes 1-3 ``train.molgen.mutate``
   steps for off-library diversity.

Host code driven by one ``random.Random(--seed)``: the same seed, ``--n`` and
inputs write the JAX script's file byte for byte.

    python3 scripts/torch_zinc_corpus.py --out corpus_zinclike.txt --ref-dir DIR \\
        [--n 150000] [--seed 41] [--mutate 0.3]

Check the output against the target distribution with
``scripts/torch_chemotype_stats.py --extra <out>``.
"""

from __future__ import annotations

import argparse
import bisect
import os
import random
import sys
import time
from dataclasses import dataclass, field

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodalspectraltransformer_torch.chem import api as chem_api  # noqa: E402
from multimodalspectraltransformer_torch.chem.canonical import write_smiles  # noqa: E402
from multimodalspectraltransformer_torch.chem.smiles import (  # noqa: E402
    Atom,
    Mol,
    finalize,
    parse_smiles,
)
from multimodalspectraltransformer_torch.data.pipeline import (  # noqa: E402
    REF_TESTSET_DIR,
    load_reference_sets,
    ref_testset_split,
)
from multimodalspectraltransformer_torch.train import molgen  # noqa: E402


@dataclass
class Fragment:
    """A connected molecular piece with open attachment sites."""

    atoms: list  # list[Atom]
    bonds: list  # list[(a1, a2, order, aromatic)]
    sites: list = field(default_factory=list)  # open-valence atom indices
    n_heavy: int = 0
    has_ring: bool = False  # ring fragment vs acyclic linker


def _component(mol: Mol, keep: set[int]) -> tuple[dict[int, int], Fragment]:
    remap: dict[int, int] = {}
    atoms, bonds = [], []
    for i in sorted(keep):
        remap[i] = len(atoms)
        a = mol.atoms[i]
        atoms.append(Atom(a.symbol, a.aromatic, a.charge, a.explicit_h, a.isotope))
    ring = False
    for b in mol.bonds:
        if b.a1 in keep and b.a2 in keep:
            bonds.append((remap[b.a1], remap[b.a2], b.order, b.aromatic))
            ring = ring or b.in_ring or b.aromatic
    return remap, Fragment(atoms=atoms, bonds=bonds, n_heavy=len(atoms),
                           has_ring=ring)


def fragment_molecule(smiles: str) -> list[Fragment]:
    """Cut every acyclic non-aromatic single bond with >=2 atoms per side."""
    try:
        mol = parse_smiles(smiles)
    except Exception:
        return []
    cut = []
    for bi, b in enumerate(mol.bonds):
        if b.aromatic or b.order != 1:
            continue
        # keep terminal substituents (halogens, methyls, OH) attached to
        # their fragment — cutting them drops the 1-atom side entirely
        if mol.degree(b.a1) < 2 or mol.degree(b.a2) < 2:
            continue
        if molgen._bond_in_cycle(mol, bi):
            continue
        cut.append(bi)
    if not cut:
        return []
    # components after removing ALL cut bonds
    n = mol.num_atoms
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cutset = set(cut)
    for bi, b in enumerate(mol.bonds):
        if bi in cutset:
            continue
        ra, rb = find(b.a1), find(b.a2)
        if ra != rb:
            parent[ra] = rb
    comps: dict[int, set[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), set()).add(i)
    frags = []
    by_atom: dict[int, tuple[dict[int, int], Fragment]] = {}
    for comp in comps.values():
        if len(comp) < 2:  # single atoms make noise, not chemotype
            continue
        remap, fr = _component(mol, comp)
        frags.append(fr)
        for i in comp:
            by_atom[i] = (remap, fr)
    # record attachment sites where cut bonds ended
    for bi in cut:
        b = mol.bonds[bi]
        for end in (b.a1, b.a2):
            hit = by_atom.get(end)
            if hit is not None:
                remap, fr = hit
                fr.sites.append(remap[end])
    return [f for f in frags if f.sites]


class Library:
    """Fragment pool pre-sorted by size with prefix-sum weights.

    The r4 profile showed `assemble` spending ~70% of generation time
    rebuilding candidate lists and weight vectors per join (59M len() calls
    per 3k molecules): size-filtering becomes a bisect and weighted draw a
    second bisect over precomputed prefix sums.
    """

    def __init__(self, frags: list[Fragment]):
        self.frags = sorted(frags, key=lambda f: f.n_heavy)
        self.sizes = [f.n_heavy for f in self.frags]
        # join weight (multi-site fragments keep assemblies growable) and
        # base weight (original `1 + len(sites)`), as prefix sums
        self.prefix_join: list[float] = []
        self.prefix_base: list[float] = []
        aj = ab = 0.0
        for f in self.frags:
            aj += f.n_heavy + 3 * len(f.sites)
            ab += 1 + len(f.sites)
            self.prefix_join.append(aj)
            self.prefix_base.append(ab)

    def __len__(self):
        return len(self.frags)

    def sample_max_size(self, rng: random.Random, max_size: int) -> Fragment | None:
        """Join-weighted draw among fragments with n_heavy <= max_size."""
        k = bisect.bisect_right(self.sizes, max_size)
        if k == 0:
            return None
        top = self.prefix_join[k - 1]
        r = rng.random() * top
        return self.frags[bisect.bisect_right(self.prefix_join, r, 0, k - 1)]

    def sample_base(self, rng: random.Random) -> Fragment:
        r = rng.random() * self.prefix_base[-1]
        return self.frags[
            bisect.bisect_right(self.prefix_base, r, 0, len(self.frags) - 1)]


def _fast_smiles(m: Mol) -> str | None:
    """Validity-checked SMILES WITHOUT canonical ranking (identity DFS
    order); callers canonicalize accepted outputs through the native kernel
    afterwards, so Morgan refinement here is pure waste."""
    try:
        finalize(m, strict=True)
        return write_smiles(m)
    except Exception:
        return None


def assemble(ring_lib, link_lib,
             rng: random.Random,
             lo_atoms: int = 20, hi_atoms: int = 30) -> str | None:
    """Join random fragments at attachment sites into one molecule.

    ZINC-matching shape priors (scripts/chemotype_stats.py): ~2.2 ring
    systems per molecule connected by acyclic linkers, so assembly caps the
    ring-fragment count per molecule and fills the rest from linkers.
    Accepts raw fragment lists or prebuilt :class:`Library` objects.
    """
    if not isinstance(ring_lib, Library):
        ring_lib = Library(ring_lib)
    if not isinstance(link_lib, Library):
        link_lib = Library(link_lib)
    target = rng.randint(lo_atoms, hi_atoms)
    ring_target = rng.choice((1, 2, 2, 2, 3, 3))
    base = ring_lib.sample_base(rng)
    rings_used = 1
    atoms = [Atom(a.symbol, a.aromatic, a.charge, a.explicit_h, a.isotope)
             for a in base.atoms]
    bonds = list(base.bonds)
    open_sites = list(base.sites)
    rng.shuffle(open_sites)
    rescues = 3
    for _ in range(14):
        if len(atoms) >= target:
            break
        if not open_sites:
            # open a fresh site at a substitutable carbon (aromatic CH or
            # low-degree sp3 C) — ZINC rings routinely carry 2-3
            # substituents, but library fragments record only the cuts
            # their source molecule happened to have
            if rescues == 0:
                break
            rescues -= 1
            deg = [0] * len(atoms)
            arom_deg = [0] * len(atoms)
            for (a1, a2, order, arom) in bonds:
                deg[a1] += order if not arom else 0
                deg[a2] += order if not arom else 0
                if arom:
                    arom_deg[a1] += 1
                    arom_deg[a2] += 1
            subs = [i for i, a in enumerate(atoms)
                    if a.symbol == "C" and a.charge == 0
                    and ((a.aromatic and arom_deg[i] == 2 and deg[i] == 0)
                         or (not a.aromatic and deg[i] + arom_deg[i] <= 2))]
            if not subs:
                break
            open_sites.append(rng.choice(subs))
        site = open_sites.pop()
        room = target - len(atoms)
        want_ring = rings_used < ring_target and rng.random() < 0.4
        pool = ring_lib if want_ring else link_lib
        # multi-site fragments keep the assembly growable; plain rng.choice
        # stalls at ~19 atoms because 1-site rings terminate every branch
        other = pool.sample_max_size(rng, room + 4)
        if other is None:
            other = link_lib.sample_max_size(rng, room + 4)
            want_ring = False
        if other is None:
            continue
        osite = rng.choice(other.sites)
        s1, s2 = atoms[site].symbol, other.atoms[osite].symbol
        if s1 != "C" and s2 != "C":  # forbid hetero-hetero joins
            open_sites.insert(0, site)  # the site may suit another partner
            continue
        off = len(atoms)
        for a in other.atoms:
            atoms.append(Atom(a.symbol, a.aromatic, a.charge, a.explicit_h,
                              a.isotope))
        for (a1, a2, order, arom) in other.bonds:
            bonds.append((a1 + off, a2 + off, order, arom))
        bonds.append((site, osite + off, 1, False))
        rings_used += 1 if want_ring else 0
        rest = [s + off for s in other.sites if s != osite]
        open_sites.extend(rest)
        rng.shuffle(open_sites)
    if len(atoms) < lo_atoms - 3:  # undersized assembly: cheap early reject
        return None
    # leftover open sites become implicit hydrogens (explicit_h reset below)
    m = Mol()
    for a in atoms:
        # joins/caps changed valences; force implicit-H recount except where
        # the H count is structurally required (aromatic N-H)
        eh = a.explicit_h if (a.aromatic and a.symbol == "N") else -1
        m.add_atom(Atom(a.symbol, a.aromatic, a.charge, eh, a.isotope))
    for (a1, a2, order, arom) in bonds:
        m.add_bond(a1, a2, order, arom)
    return _fast_smiles(m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=150000)
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--mutate", type=float, default=0.3,
                    help="fraction of outputs passed through 1-3 mutate steps")
    ap.add_argument("--mw-lo", type=float, default=230.0)
    ap.add_argument("--mw-hi", type=float, default=390.0)
    ap.add_argument("--exclude", action="append", default=[],
                    help="SMILES file(s) whose canonical forms are treated "
                         "as already seen (dedup against prior corpora)")
    ap.add_argument("--ref-dir", default=REF_TESTSET_DIR)
    args = ap.parse_args(argv)
    rng = random.Random(args.seed)

    chc, h1 = load_reference_sets(args.ref_dir)
    seeds, excluded = [], set()
    for r in chc + h1:
        can = chem_api.canonicalize(r.smiles)
        if can is None:
            continue
        if ref_testset_split(r.sample_id) == "adapt":
            seeds.append(can)
        else:
            excluded.add(can)

    lib: list[Fragment] = []
    for s in seeds:
        lib.extend(fragment_molecule(s))
    ring_lib = [f for f in lib if f.has_ring]
    link_lib = [f for f in lib if not f.has_ring]
    sizes = sorted(f.n_heavy for f in lib)
    print(f"[zinc-corpus] {len(seeds)} adapt seeds -> {len(lib)} fragments "
          f"({len(ring_lib)} ring / {len(link_lib)} linker, median "
          f"{sizes[len(sizes)//2]} heavy atoms); "
          f"{len(excluded)} eval-half exclusions", flush=True)

    ring_L, link_L = Library(ring_lib), Library(link_lib)
    out: list[str] = []
    seen: set[str] = set(excluded)
    for path in args.exclude:
        n0 = len(seen)
        with open(path) as f:
            seen.update(s.strip() for s in f if s.strip())
        print(f"[zinc-corpus] excluded {len(seen) - n0} prior SMILES "
              f"from {path}", flush=True)
    nat = chem_api._native()
    trials = 0
    t0 = time.time()
    last_print = 0
    while len(out) < args.n and trials < args.n * 60:
        raw: list[str] = []
        while len(raw) < 2048 and len(out) + len(raw) < args.n \
                and trials < args.n * 60:
            trials += 1
            smi = assemble(ring_L, link_L, rng)
            if smi is None:
                continue
            if rng.random() < args.mutate:
                for _ in range(rng.randint(1, 3)):
                    try:
                        mut = molgen.mutate(parse_smiles(smi), rng)
                    except Exception:
                        mut = None
                    if mut:
                        smi = mut
            raw.append(smi)
        for can in chem_api.batch_canonicalize(raw):
            if can is None or can in seen:
                continue
            mw = nat.mol_wt(can) if nat is not None else chem_api.mol_wt(can)
            if mw is None or not (args.mw_lo <= mw <= args.mw_hi):
                continue
            seen.add(can)
            out.append(can)
        if len(out) - last_print >= 10000:
            last_print = len(out) - len(out) % 10000
            rate = len(out) / max(time.time() - t0, 1e-9)
            print(f"[zinc-corpus] {len(out)}/{args.n} "
                  f"({rate:.0f} mol/s, accept {len(out)/trials:.2f})",
                  flush=True)
    out = out[:args.n]

    rng.shuffle(out)
    with open(args.out, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"[zinc-corpus] wrote {len(out)} to {args.out} "
          f"({trials} trials, {time.time()-t0:.0f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
