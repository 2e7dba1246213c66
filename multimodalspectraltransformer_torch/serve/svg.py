"""First-party 2D molecule depiction (SVG) with per-atom coloring.

Replaces the reference's RDKit-drawn, token-probability-colored molecule
images used for explainability (`MMT_website/Runfolder/functions.py:148,171`
generate_colored_molecule; `clustering_visualization_v15_4.py:71`): the
environment carries no RDKit, so coordinates come from a stress-majorization
layout over the molecular graph (Kamada-Kawai style: ideal distance
proportional to topological distance, ring closures pulled to bond length)
and rendering is plain SVG.

The port's copy of the JAX package's ``serve/svg.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..chem.smiles import Mol, parse_smiles

BOND_LENGTH = 1.0

ATOM_COLORS = {
    "C": "#222222",
    "N": "#2544dd",
    "O": "#d42b2b",
    "S": "#b8a000",
    "F": "#1fa81f",
    "Cl": "#1fa81f",
    "Br": "#8f3a0f",
    "I": "#7a1fa8",
    "P": "#e07c00",
    "B": "#e0a37c",
    "H": "#777777",
}


def _graph_distances(mol: Mol) -> np.ndarray:
    n = mol.num_atoms
    dist = np.full((n, n), np.inf)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        seen = {s}
        while frontier:
            d += 1
            nxt = []
            for v in frontier:
                for w in mol.neighbors(v):
                    if w not in seen:
                        seen.add(w)
                        dist[s, w] = d
                        nxt.append(w)
            frontier = nxt
    return dist


def layout_2d(mol: Mol, iters: int = 300, seed: int = 0) -> np.ndarray:
    """[n, 2] coordinates via stress majorization on topological distances."""
    n = mol.num_atoms
    if n == 1:
        return np.zeros((1, 2))
    d = _graph_distances(mol)
    # disconnected fragments: place at finite, well-separated distances
    finite_max = np.max(d[np.isfinite(d)]) if np.isfinite(d).any() else 1.0
    d = np.where(np.isfinite(d), d, finite_max + 3.0)
    ideal = d * BOND_LENGTH
    w = 1.0 / np.maximum(ideal, 1e-6) ** 2
    np.fill_diagonal(w, 0.0)

    rng = np.random.RandomState(seed)
    theta = np.linspace(0, 2 * math.pi, n, endpoint=False)
    pos = np.stack([np.cos(theta), np.sin(theta)], axis=1) * (ideal.mean() / 2.0)
    pos += rng.normal(scale=0.05, size=pos.shape)

    w_sum = w.sum(axis=1, keepdims=True)
    for _ in range(iters):
        diff = pos[:, None, :] - pos[None, :, :]  # [n, n, 2]
        dist = np.sqrt((diff**2).sum(-1)) + 1e-9
        # stress majorization update
        ratio = ideal / dist
        np.fill_diagonal(ratio, 0.0)
        target = pos[None, :, :] + diff * ratio[:, :, None]
        pos = (w[:, :, None] * target).sum(axis=1) / np.maximum(w_sum, 1e-9)
    pos -= pos.mean(axis=0, keepdims=True)
    return pos


def _color_lerp(value: float) -> str:
    """0 -> pale blue, 0.5 -> white, 1 -> strong red (probability heat)."""
    v = min(max(value, 0.0), 1.0)
    if v < 0.5:
        t = v / 0.5
        r, g, b = int(120 + 135 * t), int(170 + 85 * t), 255
    else:
        t = (v - 0.5) / 0.5
        r, g, b = 255, int(255 - 170 * t), int(255 - 200 * t)
    return f"rgb({r},{g},{b})"


def mol_to_svg(
    smiles: str,
    size: int = 360,
    atom_values: Optional[Sequence[float]] = None,
    title: str = "",
) -> Optional[str]:
    """SVG depiction; `atom_values` in [0, 1] draws a heat circle behind each
    heavy atom (the explainability coloring of the reference's
    /colored_molecule route, `app.py:1011`)."""
    try:
        mol = parse_smiles(smiles)
    except Exception:
        return None
    n = mol.num_atoms
    pos = layout_2d(mol)

    span = max(pos.max(axis=0) - pos.min(axis=0)) if n > 1 else 1.0
    span = max(span, 1.0)
    margin = 0.15 * size
    scale = (size - 2 * margin) / span
    xy = (pos - pos.min(axis=0, keepdims=True)) * scale + margin
    # center
    xy += ((size - margin) - xy.max(axis=0)) / 2.0

    font = max(10, int(scale * 0.45))
    r_heat = scale * 0.42

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
        f'viewBox="0 0 {size} {size}">',
        f'<rect width="{size}" height="{size}" fill="white"/>',
    ]
    if title:
        from xml.sax.saxutils import escape

        # caller-supplied (query param / SMILES) — must be XML-escaped or
        # /api/molecule.svg is a reflected-XSS vector
        parts.append(
            f'<text x="{size/2:.1f}" y="{font + 4}" text-anchor="middle" '
            f'font-size="{font}" fill="#555" font-family="sans-serif">{escape(title)}</text>'
        )

    if atom_values is not None:
        for i in range(min(n, len(atom_values))):
            parts.append(
                f'<circle cx="{xy[i,0]:.1f}" cy="{xy[i,1]:.1f}" r="{r_heat:.1f}" '
                f'fill="{_color_lerp(float(atom_values[i]))}" opacity="0.85"/>'
            )

    # bonds
    for b in mol.bonds:
        x1, y1 = xy[b.a1]
        x2, y2 = xy[b.a2]
        dx, dy = x2 - x1, y2 - y1
        norm = math.hypot(dx, dy) or 1.0
        ox, oy = -dy / norm * scale * 0.08, dx / norm * scale * 0.08
        style = 'stroke="#333" stroke-width="1.6"'
        order = b.order if not b.aromatic else 1
        if b.aromatic:
            parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" {style}/>')
            parts.append(
                f'<line x1="{x1+ox:.1f}" y1="{y1+oy:.1f}" x2="{x2+ox:.1f}" y2="{y2+oy:.1f}" '
                'stroke="#333" stroke-width="1.0" stroke-dasharray="4,3"/>'
            )
        elif order == 1:
            parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" {style}/>')
        elif order == 2:
            parts.append(f'<line x1="{x1+ox:.1f}" y1="{y1+oy:.1f}" x2="{x2+ox:.1f}" y2="{y2+oy:.1f}" {style}/>')
            parts.append(f'<line x1="{x1-ox:.1f}" y1="{y1-oy:.1f}" x2="{x2-ox:.1f}" y2="{y2-oy:.1f}" {style}/>')
        else:
            parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" {style}/>')
            parts.append(f'<line x1="{x1+1.6*ox:.1f}" y1="{y1+1.6*oy:.1f}" x2="{x2+1.6*ox:.1f}" y2="{y2+1.6*oy:.1f}" {style}/>')
            parts.append(f'<line x1="{x1-1.6*ox:.1f}" y1="{y1-1.6*oy:.1f}" x2="{x2-1.6*ox:.1f}" y2="{y2-1.6*oy:.1f}" {style}/>')

    # atom labels: carbons unlabeled (skeletal style) unless charged/isotope
    for i, a in enumerate(mol.atoms):
        label = ""
        if a.symbol != "C" or a.charge or a.isotope:
            label = a.symbol
            h = mol.total_h(i)
            if h == 1:
                label += "H"
            elif h > 1:
                label += f"H{h}"
            if a.charge:
                label += ("+" if a.charge > 0 else "-") + (str(abs(a.charge)) if abs(a.charge) > 1 else "")
        if label:
            color = ATOM_COLORS.get(a.symbol, "#222222")
            parts.append(
                f'<circle cx="{xy[i,0]:.1f}" cy="{xy[i,1]:.1f}" r="{font*0.75:.1f}" fill="white"/>'
            )
            parts.append(
                f'<text x="{xy[i,0]:.1f}" y="{xy[i,1]+font*0.35:.1f}" text-anchor="middle" '
                f'font-size="{font}" fill="{color}" font-family="sans-serif">{label}</text>'
            )

    parts.append("</svg>")
    return "".join(parts)


def grid_svg(smiles_list: Sequence[str], per_row: int = 4, cell: int = 220) -> str:
    """Molecule grid (the reference's plot_molecule_grid,
    `plotting_v15_4.py:18-60`)."""
    tiles = []
    rows = (len(smiles_list) + per_row - 1) // per_row
    for k, smi in enumerate(smiles_list):
        svg = mol_to_svg(smi, size=cell, title=smi if len(smi) < 28 else smi[:25] + "...")
        if svg is None:
            svg = (
                f'<svg xmlns="http://www.w3.org/2000/svg" width="{cell}" height="{cell}">'
                f'<rect width="{cell}" height="{cell}" fill="#fee"/>'
                f'<text x="{cell/2}" y="{cell/2}" text-anchor="middle" font-size="12">invalid</text></svg>'
            )
        x = (k % per_row) * cell
        y = (k // per_row) * cell
        inner = svg[svg.index(">") + 1 :].rsplit("</svg>", 1)[0]
        tiles.append(f'<g transform="translate({x},{y})">{inner}</g>')
    w, h = per_row * cell, rows * cell
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" viewBox="0 0 {w} {h}">'
        + "".join(tiles)
        + "</svg>"
    )
