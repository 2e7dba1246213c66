"""Constrained molecular neighbor generation (the MolFormer-bridge
replacement).

The reference drives an external seq2seq model (deep-molecular-optimization)
to sample molecules around each target until ``MF_generations`` candidates
pass the filters: molecular weight within ``MF_delta_weight``, tanimoto above
``MF_tanimoto_filter``, Lipinski rule-of-five, and a per-Murcko-scaffold cap
``max_scaffold_generations`` (`molformer_functions_v15_4.py:126-484,
697-791`, config keys in `config_V8.json`).

This first-party generator produces structural neighbors by graph mutation
(substituent attach/detach from the full medicinal-chemistry pool in
data.molrandom, heteroatom swap, halogen swap, ring closure/opening,
bond-order mutation) + canonical dedup, applying exactly the same filter
semantics. It is deterministic given a seed, needs no external checkpoint,
and its output feeds the same improvement-cycle blending path.

For generative diversity closer in kind to the reference's trained seq2seq,
`sample_model_neighbors` additionally samples neighbors from the trained
MMT decoder itself — the target's simulated spectra are encoded and the
fan-out sampler draws candidates at elevated temperature, filtered with
the same semantics (the reference's `GenerateRunner.sample` loop,
`molformer_functions_v15_4.py:126-484`, with the MMT standing in for
MolFormer).

The port's copy of the JAX package's ``train/molgen.py``: the host part is
the same Python seeded the same way, so it generates the same molecules;
the model part runs the port's ``MultimodalTransformer`` on the device
(kernel K1 in every decode step), seeded by the same sha256 digests.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Optional

from ..chem import api as chem
from ..chem.descriptors import lipinski_ok, murcko_scaffold
from ..chem.smiles import Atom, Mol, SmilesError, finalize, parse_smiles
from ..chem.canonical import canonical_ranks, write_smiles
from ..utils.device import DeviceLike, resolve_device

HETERO_SWAPS = {"C": ["N", "O"], "N": ["C", "O"], "O": ["C", "N"]}
HALOGENS = ["F", "Cl", "Br"]


@dataclass
class MolGenConfig:
    generations_per_target: int = 30  # MF_generations
    max_trials: int = 500  # MF_max_trails
    mw_delta: float = 5.0  # MF_delta_weight
    tanimoto_min: float = 0.1  # MF_tanimoto_filter
    filter_higher_mw: bool = True  # MF_filter_higher
    max_per_scaffold: int = 10  # max_scaffold_generations
    lipinski: bool = True
    seed: int = 0


def _clone(mol: Mol) -> Mol:
    out = Mol()
    for a in mol.atoms:
        out.add_atom(Atom(a.symbol, a.aromatic, a.charge, a.explicit_h, a.isotope))
    for b in mol.bonds:
        out.add_bond(b.a1, b.a2, b.order, b.aromatic)
    return out


def _to_smiles(mol: Mol) -> Optional[str]:
    try:
        finalize(mol, strict=True)
        return write_smiles(mol, ranks=canonical_ranks(mol))
    except Exception:
        # graph mutations routinely produce chemically impossible inputs
        # (valence errors and anything downstream of them): every failure
        # just voids this mutation trial
        return None


def _rebuild_without_bond(m: Mol, drop_bond: int) -> Mol:
    out = Mol()
    for a in m.atoms:
        out.add_atom(Atom(a.symbol, a.aromatic, a.charge, a.explicit_h, a.isotope))
    for bi, b in enumerate(m.bonds):
        if bi != drop_bond:
            out.add_bond(b.a1, b.a2, b.order, b.aromatic)
    return out


def _graph_distances(m: Mol, start: int, cutoff: int) -> dict[int, int]:
    dist = {start: 0}
    frontier = [start]
    for d in range(1, cutoff + 1):
        nxt = []
        for v in frontier:
            for w in m.neighbors(v):
                if w not in dist:
                    dist[w] = d
                    nxt.append(w)
        frontier = nxt
    return dist


def _ring_close(m: Mol, rng: random.Random) -> Optional[Mol]:
    """Bond two H-bearing non-aromatic atoms at graph distance 3-5,
    forming a 4-6 membered ring."""
    n = m.num_atoms
    cands = []
    for i in range(n):
        if m.total_h(i) < 1 or m.atoms[i].aromatic:
            continue
        for j, d in _graph_distances(m, i, 5).items():
            if (
                j > i
                and 3 <= d <= 5
                and m.total_h(j) >= 1
                and not m.atoms[j].aromatic
                and m.bond_between(i, j) is None
            ):
                cands.append((i, j))
    if not cands:
        return None
    i, j = rng.choice(cands)
    m.add_bond(i, j, 1)
    return m


def _ring_open(m: Mol, rng: random.Random) -> Optional[Mol]:
    """Delete one non-aromatic ring bond (ring opening keeps the molecule
    connected by definition of a ring bond)."""
    ring_bonds = [
        bi for bi, b in enumerate(m.bonds) if not b.aromatic and _in_same_ring(m, bi)
    ]
    if not ring_bonds:
        return None
    return _rebuild_without_bond(m, rng.choice(ring_bonds))


def _in_same_ring(m: Mol, bi: int) -> bool:
    b = m.bonds[bi]
    return m.atoms[b.a1].in_ring and m.atoms[b.a2].in_ring and _bond_in_cycle(m, bi)


def _bond_in_cycle(m: Mol, bi: int) -> bool:
    """Bond is in a cycle iff its endpoints stay connected without it."""
    b = m.bonds[bi]
    seen = {b.a1}
    stack = [b.a1]
    while stack:
        v = stack.pop()
        for bj in m.adjacency[v]:
            if bj == bi:
                continue
            w = m.bonds[bj].other(v)
            if w == b.a2:
                return True
            if w not in seen:
                seen.add(w)
                stack.append(w)
    return False


def _bond_order_mutate(m: Mol, rng: random.Random) -> Optional[Mol]:
    """Promote a C-C/C-N/C-O single bond to double (both ends need an H to
    give up) or demote a non-aromatic double bond to single."""
    promote, demote = [], []
    for bi, b in enumerate(m.bonds):
        if b.aromatic:
            continue
        s1, s2 = m.atoms[b.a1].symbol, m.atoms[b.a2].symbol
        if b.order == 1 and {s1, s2} <= {"C", "N", "O"}:
            if m.total_h(b.a1) >= 1 and m.total_h(b.a2) >= 1:
                if not (m.atoms[b.a1].aromatic or m.atoms[b.a2].aromatic):
                    promote.append(bi)
        elif b.order == 2:
            demote.append(bi)
    cands = [("p", bi) for bi in promote] + [("d", bi) for bi in demote]
    if not cands:
        return None
    kind, bi = rng.choice(cands)
    m.bonds[bi].order = 2 if kind == "p" else 1
    for i in (m.bonds[bi].a1, m.bonds[bi].a2):
        m.atoms[i].explicit_h = -1
    return m


def mutate(mol: Mol, rng: random.Random) -> Optional[str]:
    """One random structural edit; returns canonical SMILES or None."""
    op = rng.random()
    m = _clone(mol)
    n = m.num_atoms
    if op < 0.30:
        # attach a substituent from the drug-like pool (data.molrandom)
        from ..data import molrandom

        finalize(m, strict=False)
        sites = [i for i in range(n) if m.total_h(i) > 0 and not m.atoms[i].aromatic]
        sites = sites or [i for i in range(n) if m.total_h(i) > 0]
        if not sites:
            return None
        sub = molrandom._template(rng.choice(molrandom.SUBSTITUENTS))
        grafted = molrandom._graft(m, rng.choice(sites), sub, 0)
        if grafted is None:
            return None
        return _to_smiles(grafted)
    elif op < 0.40:
        finalize(m, strict=False)
        m2 = _ring_close(m, rng)
        if m2 is None:
            return None
        m = m2
    elif op < 0.50:
        finalize(m, strict=False)
        m2 = _ring_open(m, rng)
        if m2 is None:
            return None
        m = m2
    elif op < 0.62:
        finalize(m, strict=False)
        m2 = _bond_order_mutate(m, rng)
        if m2 is None:
            return None
        m = m2
    elif op < 0.80:
        # delete a random terminal non-ring atom
        finalize(m, strict=False)
        terminals = [i for i in range(n) if m.degree(i) == 1 and not m.atoms[i].in_ring]
        if len(terminals) == 0 or n <= 3:
            return None
        victim = rng.choice(terminals)
        cut_order = {j: (m.bond_between(victim, j).order if m.bond_between(victim, j) else 1)
                     for j in m.neighbors(victim)}
        keep = [i for i in range(n) if i != victim]
        m2 = Mol()
        remap = {}
        for i in keep:
            a = m.atoms[i]
            # only the deleted atom's neighbor gains valence: re-derive its
            # implicit H (or bump its bracket H by the cut bond order).
            # Resetting explicit_h everywhere would silently drop required
            # bracket hydrogens (e.g. pyrrole [nH]).
            eh = a.explicit_h
            if i in cut_order:
                eh = -1 if a.explicit_h < 0 else a.explicit_h + cut_order[i]
            remap[i] = m2.add_atom(Atom(a.symbol, a.aromatic, a.charge, eh, a.isotope))
        for b in m.bonds:
            if b.a1 in remap and b.a2 in remap:
                m2.add_bond(remap[b.a1], remap[b.a2], b.order, b.aromatic)
        m = m2
    else:
        # swap one atom's element (heteroatom or halogen swap)
        finalize(m, strict=False)
        cands = [
            i for i in range(n)
            if (m.atoms[i].symbol in HETERO_SWAPS and not m.atoms[i].aromatic)
            or m.atoms[i].symbol in HALOGENS
        ]
        if not cands:
            return None
        i = rng.choice(cands)
        sym = m.atoms[i].symbol
        if sym in HALOGENS:
            new = rng.choice([h for h in HALOGENS if h != sym])
        else:
            new = rng.choice(HETERO_SWAPS[sym])
        m.atoms[i].symbol = new
        m.atoms[i].explicit_h = -1
    return _to_smiles(m)


def generate_neighbors(target_smiles: str, cfg: MolGenConfig = MolGenConfig()) -> list[str]:
    """Generate up to ``generations_per_target`` filtered neighbors."""
    can = chem.canonicalize(target_smiles)
    if can is None:
        return []
    target_mw = chem.mol_wt(can)
    # process-stable seed: Python's str hash is salted per interpreter
    # (PYTHONHASHSEED), which would make generation non-reproducible
    digest = hashlib.sha256(f"{cfg.seed}|{can}".encode()).digest()
    rng = random.Random(int.from_bytes(digest[:8], "little"))
    try:
        base = parse_smiles(can)
    except SmilesError:
        return []

    accepted: list[str] = []
    pool = [can]
    seen = {can}
    scaffold_counts: dict[str, int] = {}
    for _trial in range(cfg.max_trials):
        if len(accepted) >= cfg.generations_per_target:
            break
        src = parse_smiles(rng.choice(pool))
        smi = mutate(src, rng)
        if smi is None or smi in seen:
            continue
        seen.add(smi)
        if not _passes_filters(smi, can, target_mw, cfg, scaffold_counts):
            continue
        accepted.append(smi)
        pool.append(smi)  # allow multi-step walks
    return accepted


def generate_for_targets(targets: list[str], cfg: MolGenConfig = MolGenConfig()) -> dict[str, list[str]]:
    return {t: generate_neighbors(t, cfg) for t in targets}


def _passes_filters(
    smi: str, can: str, target_mw: float, cfg: MolGenConfig,
    scaffold_counts: dict[str, int],
) -> bool:
    """The shared MolFormer-bridge acceptance test
    (`molformer_functions_v15_4.py:126-484` filter semantics)."""
    mw = chem.mol_wt(smi)
    if mw is None:
        return False
    if cfg.filter_higher_mw and mw > target_mw + cfg.mw_delta:
        return False
    if abs(mw - target_mw) > max(cfg.mw_delta * 10, 100):
        return False
    t = chem.tanimoto(smi, can)
    if t is None or t < cfg.tanimoto_min:
        return False
    if cfg.lipinski and not lipinski_ok(smi):
        return False
    scaf = murcko_scaffold(smi) or ""
    if scaffold_counts.get(scaf, 0) >= cfg.max_per_scaffold:
        return False
    scaffold_counts[scaf] = scaffold_counts.get(scaf, 0) + 1
    return True


def _model_dcfg(cfg: MolGenConfig, fanout: int, temperature: float, max_rounds: int):
    from ..utils.config import DecodeConfig

    # NO decode-side MW window: the sampler's gate is symmetric +-mw_delta,
    # but the MolFormer-bridge semantics (_passes_filters / the reference's
    # MF_filter_higher) only cap the HIGH side — let the shared filters
    # decide, identically to the graph-mutation path
    return DecodeConfig(
        fanout=fanout,
        multinom_runs=cfg.generations_per_target * 3,  # pre-filter surplus
        max_temp_rounds=max_rounds,
        temperature=temperature,
        mw_filter=False,
    )


def _digest_seed(text: str) -> int:
    """The first 4 bytes of sha256(text), little-endian: the integer the JAX
    package seeds its PRNGKey with."""
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "little")


def sample_model_neighbors(
    model,
    target_smiles: str,
    cfg: MolGenConfig = MolGenConfig(),
    fanout: int = 64,
    temperature: float = 1.1,
    max_rounds: int = 4,
    record=None,
    device: DeviceLike = None,
) -> list[str]:
    """Neighbors sampled from the trained MMT decoder itself (a
    ``MultimodalTransformer``, on ``device``: cuda unless asked otherwise):
    the target's simulated spectra are encoded and the fan-out sampler draws
    candidates at elevated temperature, filtered with the same
    MolFormer-bridge semantics. Pass ``record`` (a SampleRecord with this
    molecule's spectra) to skip the factory call."""
    from ..data import pipeline as dp
    from ..eval import generation
    from ..models.mmt import MMTBatch

    dev = resolve_device(device)
    can = chem.canonicalize(target_smiles)
    if can is None:
        return []
    if record is None:
        from ..sim import factory as sim_factory

        recs = sim_factory.simulate_records([can], device=dev)
        if not recs:
            return []
        record = recs[0]
    feats = dp.featurize(record, model.cfg)
    if feats is None:
        return []
    model = model.to(dev)
    enc = model.encode(MMTBatch(*dp.collate([feats]).inputs).to(dev))
    cands = generation.generate_candidates(
        model.state_dict(), model.cfg, enc.memory, enc.memory_key_padding_mask,
        _digest_seed(f"{cfg.seed}|model|{can}"),
        _model_dcfg(cfg, fanout, temperature, max_rounds), device=dev,
    )
    return _filter_neighbor_pool(cands.smiles, can, chem.mol_wt(can) or 0.0, cfg)


def _filter_neighbor_pool(smiles, can, target_mw, cfg) -> list[str]:
    accepted: list[str] = []
    scaffold_counts: dict[str, int] = {}
    for smi in smiles:
        if smi == can or smi in accepted:
            continue
        if _passes_filters(smi, can, target_mw, cfg, scaffold_counts):
            accepted.append(smi)
        if len(accepted) >= cfg.generations_per_target:
            break
    return accepted


def sample_model_neighbors_batch(
    model,
    records,  # list[SampleRecord] with spectra for each target
    cfg: MolGenConfig = MolGenConfig(),
    fanout: int = 64,
    temperature: float = 1.1,
    max_rounds: int = 4,
    chunk: int = 24,
    device: DeviceLike = None,
) -> list[list[str]]:
    """:func:`sample_model_neighbors` over MANY targets per decode: ``chunk``
    targets share each fan-out round (``generate_candidates_batch``), with
    identical filter semantics per target. Each chunk's seed is the sha256
    digest of the MolGen seed and the chunk's canonical SMILES, as in the JAX
    package. Returns one accepted-neighbor list per input record."""
    from ..data import pipeline as dp
    from ..eval import generation
    from ..models.mmt import MMTBatch

    dev = resolve_device(device)
    model = model.to(dev)
    params = model.state_dict()
    dcfg = _model_dcfg(cfg, fanout, temperature, max_rounds)
    out: list[list[str]] = []
    for s in range(0, len(records), chunk):
        block = records[s : s + chunk]
        cans, feats = [], []
        for r in block:
            can = chem.canonicalize(r.smiles)
            f = dp.featurize(r, model.cfg) if can is not None else None
            if f is None:
                continue
            cans.append(can)
            feats.append(f)
        if not feats:
            out.extend([[] for _ in block])
            continue
        enc = model.encode(MMTBatch(*dp.collate(feats).inputs).to(dev))
        sets = generation.generate_candidates_batch(
            params, model.cfg, enc.memory, enc.memory_key_padding_mask,
            _digest_seed(f"{cfg.seed}|model-batch|{'|'.join(cans)}"), dcfg, device=dev,
        )
        by_can = {
            c: _filter_neighbor_pool(cs.smiles, c, chem.mol_wt(c) or 0.0, cfg)
            for c, cs in zip(cans, sets)
        }
        for r in block:
            out.append(by_can.get(chem.canonicalize(r.smiles), []))
    return out


def pool_diversity(smiles_list: list) -> dict:
    """Diversity statistics for a generated neighbor pool (the evidence the
    MolFormer-bridge claim needs: a useful generator produces *varied*
    neighbors, not the same mutation applied thrice). Reports unique count,
    mean pairwise Morgan-tanimoto (lower = more diverse), ring-system
    count spread, and MW spread — all first-party chemistry."""
    import numpy as np

    from ..chem import api as chem

    cans = sorted({c for c in chem.batch_canonicalize(list(smiles_list)) if c})
    out = {"n": len(smiles_list), "n_unique": len(cans)}
    if len(cans) < 2:
        out.update(mean_pairwise_tanimoto=1.0 if cans else 0.0,
                   mw_std=0.0, ring_counts={})
        return out
    fps, ok = chem.batch_morgan_fp(cans)
    fps = fps[ok]
    if len(fps) >= 2:
        # vectorized pairwise tanimoto over the packed bit arrays
        inter = (fps[:, None, :] & fps[None, :, :]).sum(-1).astype(float)
        union = (fps[:, None, :] | fps[None, :, :]).sum(-1).astype(float)
        iu = np.triu_indices(len(fps), 1)
        pair = inter[iu] / np.maximum(union[iu], 1.0)
        out["mean_pairwise_tanimoto"] = float(pair.mean())
    mws = chem.batch_exact_mol_wt(cans)
    mws = mws[~np.isnan(mws)]
    out["mw_std"] = float(mws.std()) if len(mws) else 0.0
    rings = {}
    from ..chem.smiles import parse_smiles

    for c in cans:
        try:
            m = parse_smiles(c)
        except Exception:
            continue
        k = sum(1 for b in m.bonds if getattr(b, "in_ring", False))
        rings[k] = rings.get(k, 0) + 1
    out["ring_bond_histogram"] = rings
    return out
