"""Server-side SVG spectra plots.

Replaces the reference's Plotly JSON endpoints (`app.py:287-427 /plot_nmr`,
`:1114-1260 /plot_dual_NMR`) with self-contained SVG (no CDN dependency —
the deployment environment has zero egress). Supports single and dual
(experimental vs simulated) overlays for all five modalities.

The port's copy of the JAX package's ``serve/plots.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

W, H = 640, 360
ML, MR, MT, MB = 56, 16, 28, 42  # margins

def _esc(text) -> str:
    from xml.sax.saxutils import escape

    return escape(str(text))


_COLORS = ("#2563eb", "#dc2626")  # primary / overlay


def _axes(x0: float, x1: float, y0: float, y1: float, xlabel: str, ylabel: str,
          title: str, invert_x: bool = True, invert_y: bool = False):
    """Return (header parts, to_px) for a standard NMR-style plot frame
    (ppm axes increase right-to-left, 2D NMR also top-to-bottom)."""
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1.0
    px_w, px_h = W - ML - MR, H - MT - MB

    def to_px(x, y):
        fx = (x - x0) / (x1 - x0)
        fy = (y - y0) / (y1 - y0)
        if invert_x:
            fx = 1.0 - fx
        if not invert_y:
            fy = 1.0 - fy
        return ML + fx * px_w, MT + fy * px_h

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" viewBox="0 0 {W} {H}">',
        f'<rect width="{W}" height="{H}" fill="white"/>',
        f'<rect x="{ML}" y="{MT}" width="{px_w}" height="{px_h}" fill="none" stroke="#aaa"/>',
        # titles carry caller-supplied text (record SMILES / query params):
        # XML-escape or spectra plots become an SVG-injection vector
        f'<text x="{W/2}" y="{MT-10}" text-anchor="middle" font-size="13" fill="#333" font-family="sans-serif">{_esc(title)}</text>',
        f'<text x="{W/2}" y="{H-8}" text-anchor="middle" font-size="12" fill="#555" font-family="sans-serif">{_esc(xlabel)}</text>',
        f'<text x="14" y="{H/2}" text-anchor="middle" font-size="12" fill="#555" font-family="sans-serif" transform="rotate(-90 14 {H/2})">{_esc(ylabel)}</text>',
    ]
    # ticks
    for k in range(6):
        xv = x0 + (x1 - x0) * k / 5
        px, _ = to_px(xv, y0)
        parts.append(f'<line x1="{px:.1f}" y1="{H-MB}" x2="{px:.1f}" y2="{H-MB+4}" stroke="#888"/>')
        parts.append(
            f'<text x="{px:.1f}" y="{H-MB+16}" text-anchor="middle" font-size="10" fill="#555" font-family="sans-serif">{xv:.1f}</text>'
        )
        yv = y0 + (y1 - y0) * k / 5
        _, py = to_px(x0, yv)
        parts.append(f'<line x1="{ML-4}" y1="{py:.1f}" x2="{ML}" y2="{py:.1f}" stroke="#888"/>')
        parts.append(
            f'<text x="{ML-7}" y="{py+3:.1f}" text-anchor="end" font-size="10" fill="#555" font-family="sans-serif">{yv:.1f}</text>'
        )
    return parts, to_px


def _finish(parts: list[str], legend: Optional[Sequence[str]] = None) -> str:
    if legend:
        for i, name in enumerate(legend):
            y = MT + 14 + i * 16
            parts.append(f'<rect x="{W-MR-120}" y="{y-9}" width="10" height="10" fill="{_COLORS[i % 2]}"/>')
            parts.append(
                f'<text x="{W-MR-105}" y="{y}" font-size="11" fill="#333" font-family="sans-serif">{_esc(name)}</text>'
            )
    parts.append("</svg>")
    return "".join(parts)


def plot_1d_sticks(
    peaks: Sequence[Sequence[float]],
    overlay: Optional[Sequence[Sequence[float]]] = None,
    xlabel: str = "1H shift (ppm)",
    title: str = "1H NMR",
    legend: Optional[Sequence[str]] = None,
) -> str:
    """Stick spectrum for (shift, intensity) peaks; 13C passes intensity 1."""
    sets = [np.asarray(peaks, dtype=float).reshape(-1, 2)]
    if overlay is not None:
        sets.append(np.asarray(overlay, dtype=float).reshape(-1, 2))
    allp = np.concatenate([s for s in sets if len(s)]) if any(len(s) for s in sets) else np.zeros((1, 2))
    x0, x1 = float(allp[:, 0].min()), float(allp[:, 0].max())
    pad = max(0.5, 0.05 * (x1 - x0))
    ymax = max(float(allp[:, 1].max()), 1e-6)
    parts, to_px = _axes(x0 - pad, x1 + pad, 0.0, ymax * 1.05, xlabel, "intensity", title)
    for si, s in enumerate(sets):
        color = _COLORS[si % 2]
        for shift, inten in s:
            px, py = to_px(shift, inten)
            _, py0 = to_px(shift, 0.0)
            parts.append(f'<line x1="{px:.1f}" y1="{py0:.1f}" x2="{px:.1f}" y2="{py:.1f}" stroke="{color}" stroke-width="1.6"/>')
    return _finish(parts, legend)


def plot_1h_lorentzian(
    peaks: Sequence[Sequence[float]],
    overlay: Optional[Sequence[Sequence[float]]] = None,
    gamma: float = 0.01,
    title: str = "1H NMR (line shape)",
    legend: Optional[Sequence[str]] = None,
) -> str:
    """Continuous Lorentzian line-shape rendering of a (shift, intensity)
    peak list with sticks underneath (the reference's `simulate_splitting`
    display, `data_generation_v15_4.py:122-134,564-573`)."""
    from ..sim.reconstruct import render_lorentzian

    sets = [[tuple(p) for p in peaks]]
    if overlay is not None:
        sets.append([tuple(p) for p in overlay])
    curves = [render_lorentzian(s, gamma=gamma) for s in sets]
    x0 = min(float(c[0].min()) for c in curves)
    x1 = max(float(c[0].max()) for c in curves)
    ymax = max(float(c[1].max()) for c in curves) or 1.0
    parts, to_px = _axes(x0, x1, 0.0, ymax * 1.05, "1H shift (ppm)", "intensity", title)
    for si, (xs, ys) in enumerate(curves):
        pts = []
        for k in range(0, len(xs), 2):
            px, py = to_px(float(xs[k]), float(ys[k]))
            pts.append(f"{px:.1f},{py:.1f}")
        parts.append(
            f'<polyline points="{" ".join(pts)}" fill="none" stroke="{_COLORS[si % 2]}" stroke-width="1.4"/>'
        )
    # faint sticks underneath for peak positions
    stick_scale = ymax / (max((v for _, v in sets[0]), default=1.0) or 1.0)
    for shift, inten in sets[0]:
        px, py = to_px(shift, inten * stick_scale * 0.25)
        _, py0 = to_px(shift, 0.0)
        parts.append(
            f'<line x1="{px:.1f}" y1="{py0:.1f}" x2="{px:.1f}" y2="{py:.1f}" stroke="{_COLORS[0]}" stroke-width="0.8" opacity="0.45"/>'
        )
    return _finish(parts, legend)


def plot_2d_scatter(
    peaks: Sequence[Sequence[float]],
    overlay: Optional[Sequence[Sequence[float]]] = None,
    xlabel: str = "1H (ppm)",
    ylabel: str = "13C (ppm)",
    title: str = "HSQC",
    legend: Optional[Sequence[str]] = None,
) -> str:
    """2D correlation scatter ((x, y) ppm pairs), ppm axes inverted; used for
    HSQC (H vs C) and COSY (H vs H), single or dual overlay
    (reference /plot_dual_NMR)."""
    sets = [np.asarray(peaks, dtype=float).reshape(-1, 2)]
    if overlay is not None:
        sets.append(np.asarray(overlay, dtype=float).reshape(-1, 2))
    allp = np.concatenate([s for s in sets if len(s)]) if any(len(s) for s in sets) else np.zeros((1, 2))
    padx = max(0.4, 0.07 * (float(np.ptp(allp[:, 0])) or 1))
    pady = max(3.0 if "13C" in ylabel else 0.4, 0.07 * (float(np.ptp(allp[:, 1])) or 1))
    parts, to_px = _axes(
        float(allp[:, 0].min()) - padx, float(allp[:, 0].max()) + padx,
        float(allp[:, 1].min()) - pady, float(allp[:, 1].max()) + pady,
        xlabel, ylabel, title, invert_x=True, invert_y=True,
    )
    for si, s in enumerate(sets):
        color = _COLORS[si % 2]
        for x, y in s:
            px, py = to_px(x, y)
            if si == 0:
                parts.append(f'<circle cx="{px:.1f}" cy="{py:.1f}" r="4" fill="{color}" opacity="0.8"/>')
            else:
                parts.append(
                    f'<path d="M {px-4:.1f} {py-4:.1f} L {px+4:.1f} {py+4:.1f} M {px-4:.1f} {py+4:.1f} L {px+4:.1f} {py-4:.1f}" '
                    f'stroke="{color}" stroke-width="1.8" fill="none"/>'
                )
    return _finish(parts, legend)


def plot_ir(
    spectrum: Sequence[float],
    overlay: Optional[Sequence[float]] = None,
    title: str = "IR",
    legend: Optional[Sequence[str]] = None,
) -> str:
    """IR absorbance curve (index-binned, 400-4000 cm^-1 convention of the
    chemprop-IR 1801-point grid, downsampled views included)."""
    sets = [np.asarray(spectrum, dtype=float).ravel()]
    if overlay is not None:
        sets.append(np.asarray(overlay, dtype=float).ravel())
    wn0, wn1 = 400.0, 4000.0
    # empty spectra draw empty axes instead of raising (max of no args)
    ymax = max((float(np.nanmax(s)) for s in sets if len(s)), default=1.0) or 1.0
    parts, to_px = _axes(wn0, wn1, 0.0, ymax * 1.05, "wavenumber (cm-1)", "absorbance", title)
    for si, s in enumerate(sets):
        if not len(s):
            continue
        s = np.nan_to_num(np.asarray(s, float), nan=0.0)  # NaN aborts SVG polylines
        xs = np.linspace(wn0, wn1, len(s))
        pts = []
        step = max(1, len(s) // 900)
        for k in range(0, len(s), step):
            px, py = to_px(xs[k], float(s[k]))
            pts.append(f"{px:.1f},{py:.1f}")
        parts.append(
            f'<polyline points="{" ".join(pts)}" fill="none" stroke="{_COLORS[si % 2]}" stroke-width="1.4"/>'
        )
    return _finish(parts, legend)


def plot_record(record, modality: str, overlay_record=None) -> Optional[str]:
    """Plot one modality of a data.pipeline.SampleRecord (overlay optional)."""
    o = overlay_record

    def leg(over):
        # the legend advertises two series only when the overlay is
        # actually drawn for THIS modality
        return ["primary", "overlay"] if over is not None else None

    if modality == "1H" and record.h1:
        over = o.h1 if o and o.h1 else None
        return plot_1d_sticks(record.h1, over, title=f"1H — {record.smiles}", legend=leg(over))
    if modality == "1H_shape" and record.h1:
        over = o.h1 if o and o.h1 else None
        return plot_1h_lorentzian(record.h1, over, title=f"1H — {record.smiles}", legend=leg(over))
    if modality == "13C" and record.c13:
        peaks = [[c, 1.0] for c in record.c13]
        over = [[c, 1.0] for c in o.c13] if o and o.c13 else None
        return plot_1d_sticks(peaks, over, xlabel="13C shift (ppm)", title=f"13C — {record.smiles}", legend=leg(over))
    if modality == "HSQC" and record.hsqc:
        pk = [[h, c] for h, c in record.hsqc]
        over = [[h, c] for h, c in o.hsqc] if o and o.hsqc else None
        return plot_2d_scatter(pk, over, title=f"HSQC — {record.smiles}", legend=leg(over))
    if modality == "COSY" and record.cosy:
        over = o.cosy if o and o.cosy else None
        return plot_2d_scatter(record.cosy, over, ylabel="1H (ppm)", title=f"COSY — {record.smiles}", legend=leg(over))
    if modality == "IR" and record.ir is not None:
        over = o.ir if o is not None and o.ir is not None else None
        return plot_ir(record.ir, over, title=f"IR — {record.smiles}", legend=leg(over))
    return None
