"""Embedding-space clustering & visualization.

Reference: `clustering_visualization_v15_4.py:28-384` — t-SNE/UMAP/PCA
projections of MMT fingerprints with molecular-formula/MW coloring, written
out as plotly HTML (`generate_colored_html:71`, `plot_cluster_MF:257`).
The port's own copy of the JAX package's ``eval/clustering.py``: PCA is
first-party (numpy SVD), UMAP is ``eval/umap.py``, t-SNE comes from sklearn
and the PNG from matplotlib, both imported only when called (neither is
installed beside the card); the standalone HTML scatter with hover tooltips
needs neither.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..chem import api as chem


def pca(vectors: np.ndarray, n_components: int = 2) -> np.ndarray:
    """First-party PCA via SVD on centered data."""
    x = np.asarray(vectors, dtype=np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    _u, _s, vt = np.linalg.svd(x, full_matrices=False)
    return np.asarray(x @ vt[:n_components].T, dtype=np.float32)


def embed(vectors: np.ndarray, method: str = "pca", n_components: int = 2,
          random_state: int = 0) -> np.ndarray:
    """Project [N, D] vectors to n_components dims. methods: pca | tsne |
    umap (first-party implementation, eval/umap.py — no silent t-SNE
    fallback anymore)."""
    if method == "pca":
        return pca(vectors, n_components)
    if method == "umap":
        from .umap import umap_embed

        return umap_embed(
            np.asarray(vectors, np.float64),
            n_components=n_components,
            random_state=random_state,
        )
    if method == "tsne":
        from sklearn.manifold import TSNE

        n = len(vectors)
        # sklearn requires perplexity < n_samples (floor of 2.0 broke n=2)
        perplexity = min(max(2.0, min(30.0, (n - 1) / 3.0)), max(n - 1.0, 1.0))
        return np.asarray(
            TSNE(n_components=n_components, random_state=random_state,
                 perplexity=perplexity, init="pca").fit_transform(np.asarray(vectors, np.float32)),
            dtype=np.float32,
        )
    raise ValueError(f"unknown method {method!r}")


def mw_labels(smiles_list: Sequence[str], edges=(250.0, 350.0, 500.0)) -> list[str]:
    """MW bucket per molecule (the reference's ZINC/PubChem MW slices)."""
    wts = chem.batch_exact_mol_wt(smiles_list)
    out = []
    for w in wts:
        if np.isnan(w):
            out.append("invalid")
        else:
            for e in edges:
                if w <= e:
                    out.append(f"<= {e:.0f}")
                    break
            else:
                out.append(f"> {edges[-1]:.0f}")
    return out


def formula_labels(smiles_list: Sequence[str]) -> list[str]:
    """Molecular-formula label per molecule (plot_cluster_MF coloring)."""
    return [chem.mol_formula(s) or "invalid" for s in smiles_list]


_PALETTE = (
    "#2563eb", "#dc2626", "#16a34a", "#d97706", "#7c3aed",
    "#0891b2", "#db2777", "#65a30d", "#475569", "#b45309",
)


def cluster_plot_png(
    coords: np.ndarray,
    labels: Optional[Sequence[str]],
    path: str,
    title: str = "fingerprint embedding",
) -> str:
    """Matplotlib scatter (PNG), colored by label class."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    if labels is None:
        ax.scatter(coords[:, 0], coords[:, 1], s=14, alpha=0.7)
    else:
        uniq = sorted(set(labels))
        for i, lab in enumerate(uniq):
            mask = np.array([l == lab for l in labels])
            ax.scatter(coords[mask, 0], coords[mask, 1], s=14, alpha=0.75,
                       color=_PALETTE[i % len(_PALETTE)], label=str(lab))
        if len(uniq) <= 12:
            ax.legend(fontsize=8, loc="best")
    ax.set_title(title)
    ax.set_xlabel("dim 1")
    ax.set_ylabel("dim 2")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def cluster_plot_html(
    coords: np.ndarray,
    smiles_list: Sequence[str],
    path: str,
    labels: Optional[Sequence[str]] = None,
    title: str = "fingerprint embedding",
) -> str:
    """Standalone interactive-enough HTML: SVG scatter with per-point hover
    tooltips (SMILES + label) — the zero-dependency stand-in for the
    reference's plotly HTML export."""
    c = np.asarray(coords, dtype=float)
    if c.size == 0:
        raise ValueError("cluster_plot_html: no points to plot (empty coords)")
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    w, h, m = 760, 640, 40
    label_list = list(labels) if labels is not None else ["all"] * len(smiles_list)
    uniq = sorted(set(label_list))
    color_of = {lab: _PALETTE[i % len(_PALETTE)] for i, lab in enumerate(uniq)}
    from html import escape

    pts = []
    for (x, y), smi, lab in zip(c, smiles_list, label_list):
        px = m + (x - lo[0]) / span[0] * (w - 2 * m)
        py = h - m - (y - lo[1]) / span[1] * (h - 2 * m)
        pts.append(
            f'<circle cx="{px:.1f}" cy="{py:.1f}" r="4.5" fill="{color_of[lab]}" opacity="0.75">'
            f"<title>{escape(str(smi))} | {escape(str(lab))}</title></circle>"
        )
    legend = "".join(
        f'<div><span style="display:inline-block;width:10px;height:10px;background:{color_of[u]}"></span> {escape(str(u))}</div>'
        for u in uniq[:20]
    )
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{escape(str(title))}</title></head><body><h3>{escape(str(title))}</h3>"
        f'<svg width="{w}" height="{h}" style="border:1px solid #ccc">'
        + "".join(pts) + "</svg>" + legend + "</body></html>"
    )
    with open(path, "w") as f:
        f.write(html)
    return path
