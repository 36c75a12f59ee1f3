"""Publication figures shared by the harnesses (a copy of
``scasml_gp_tpu/harness/plots.py``).

The figures of SimpleUniform and RepeatedExperiment, palette GP black
#000000, MLP gray #A6A3A4, SCaSML teal #2C939A, rendered with matplotlib's
Agg backend so harnesses run headless.  matplotlib is imported by the
plotting functions only, so a host without it imports this module and runs
``hexbin_stats``; a plotting call there raises ImportError.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

COLOR_SCHEME = {
    "GP": "#000000",
    "MLP": "#A6A3A4",
    "SCaSML": "#2C939A",
}

_RC = {
    "font.family": "DejaVu Sans",
    "font.size": 8,
    "axes.labelsize": 9,
    "legend.fontsize": 7,
    "xtick.labelsize": 7,
    "ytick.labelsize": 7,
    "axes.linewidth": 0.6,
    "lines.linewidth": 0.8,
    "savefig.dpi": 300,
}


def _save(fig, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight", pad_inches=0.05)
    _pyplot().close(fig)


def error_violin(errors: Dict[str, np.ndarray], path: str):
    """Absolute-error distribution per solver (reference Figure 1)."""
    plt = _pyplot()
    with plt.rc_context(_RC):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        names = list(errors)
        vp = ax.violinplot(
            [np.abs(errors[n]) + 1e-12 for n in names],
            showmeans=False,
            showmedians=True,
        )
        for pc, name in zip(vp["bodies"], names):
            pc.set_facecolor(COLOR_SCHEME.get(name, "#888888"))
            pc.set_edgecolor("black")
            pc.set_alpha(0.8)
        ax.set_yscale("log")
        ax.set_ylabel("Absolute Error", labelpad=2)
        ax.set_xticks(range(1, len(names) + 1))
        ax.set_xticklabels(names, rotation=45, ha="right")
        ax.grid(axis="y", linestyle="--", alpha=0.4)
        ax.spines[["top", "right"]].set_visible(False)
        _save(fig, path)


def hexbin_stats(diff: np.ndarray) -> dict:
    """Positive/negative count and sum of an error-difference vector
    (reference tests/SimpleUniform.py:283-291 annotates these on the maps
    and logs them, :490-510)."""
    diff = np.asarray(diff, np.float64)
    return {
        "positive_count": int(np.sum(diff > 0)),
        "negative_count": int(np.sum(diff < 0)),
        "positive_sum": float(np.sum(diff[diff > 0])),
        "negative_sum": float(np.sum(diff[diff < 0])),
    }


def diff_hexbin(coords: np.ndarray, diff: np.ndarray, label: str, path: str):
    """Spatial map of error differences with the count/sum stat box
    (reference tests/SimpleUniform.py:270-300, Figures 2-3)."""
    plt = _pyplot()
    with plt.rc_context(_RC):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        lim = max(float(np.abs(diff).max()), 1e-12)
        hb = ax.hexbin(
            coords[:, 0], coords[:, 1], C=diff, cmap="coolwarm", gridsize=30,
            reduce_C_function=np.mean, mincnt=1, vmin=-lim, vmax=lim,
        )
        cb = fig.colorbar(hb, ax=ax, pad=0.02)
        cb.set_label(label, rotation=270, labelpad=10)
        cb.set_ticks([-lim, 0, lim])
        st = hexbin_stats(diff)
        ax.text(
            0.95, 0.95,
            f"Positive count: {st['positive_count']}\n"
            f"Negative count: {st['negative_count']}\n"
            f"Positive sum: {st['positive_sum']:.2f}\n"
            f"Negative sum: {st['negative_sum']:.2f}",
            transform=ax.transAxes, ha="right", va="top", fontsize=7,
            bbox=dict(facecolor="white", alpha=0.8, edgecolor="none"),
        )
        ax.set_xlabel("$x_1$")
        ax.set_ylabel("$x_2$")
        _save(fig, path)


def spatiotemporal_heatmap(
    coords: np.ndarray, abs_err: np.ndarray, label: str, path: str,
    grid_num: int = 3,
):
    """Binned (x1, x2) mean-L1-error heatmap, one per solver (reference
    tests/SimpleUniform.py:338-398: 3x3 cells, viridis, log color scale,
    per-cell value annotations)."""
    x1, x2 = coords[:, 0], coords[:, 1]
    x1_bins = np.linspace(x1.min(), x1.max(), grid_num + 1)
    x2_bins = np.linspace(x2.min(), x2.max(), grid_num + 1)
    grid = np.zeros((grid_num, grid_num))
    for i in range(grid_num):
        for j in range(grid_num):
            m = (
                (x1 >= x1_bins[j]) & (x1 < x1_bins[j + 1])
                & (x2 >= x2_bins[i]) & (x2 < x2_bins[i + 1])
            )
            if m.any():
                grid[i, j] = abs_err[m].mean()
    plt = _pyplot()
    with plt.rc_context(_RC):
        from matplotlib.colors import LogNorm

        fig, ax = plt.subplots(figsize=(3.5, 3))
        im = ax.pcolormesh(
            x1_bins, x2_bins, grid, cmap="viridis",
            norm=LogNorm(vmin=1e-4, vmax=10), shading="auto",
        )
        for i in range(grid_num):
            for j in range(grid_num):
                if grid[i, j] > 0:
                    ax.text(
                        (x1_bins[j] + x1_bins[j + 1]) / 2,
                        (x2_bins[i] + x2_bins[i + 1]) / 2,
                        f"{grid[i, j]:.2e}",
                        ha="center", va="center", color="black", fontsize=6,
                    )
        cb = fig.colorbar(im, ax=ax, pad=0.02)
        cb.set_label(f"{label} L1 Error (log scale)", rotation=270, labelpad=10)
        ax.set_xlabel("$x_1$")
        ax.set_ylabel("$x_2$")
        _save(fig, path)


def error_bars(metrics: Dict[str, Dict[str, float]], key: str, path: str):
    """Bar chart of one error metric per solver."""
    plt = _pyplot()
    with plt.rc_context(_RC):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        names = list(metrics)
        vals = [metrics[n][key] for n in names]
        ax.bar(names, vals, color=[COLOR_SCHEME.get(n, "#888888") for n in names])
        ax.set_ylabel(key)
        ax.spines[["top", "right"]].set_visible(False)
        _save(fig, path)


def improvement_bars(
    metrics: Dict[str, Dict[str, float]], key: str, path: str,
    ref: str = "SCaSML",
):
    """Error bars annotated with ``ref``'s improvement over each other solver
    (reference tests/SimpleUniform.py:290-335, Relative_L2_Improvement.pdf)."""
    plt = _pyplot()
    with plt.rc_context(_RC):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        names = list(metrics)
        vals = [metrics[n][key] for n in names]
        ax.bar(names, vals, color=[COLOR_SCHEME.get(n, "#888888") for n in names])
        ref_val = metrics[ref][key]
        for i, n in enumerate(names):
            if n == ref:
                continue
            imp = (vals[i] - ref_val) / vals[i] * 100 if vals[i] else 0.0
            sign = "-" if imp > 0 else ("+" if imp < 0 else "")
            ax.text(i, vals[i] * 1.05, f"{sign}{abs(imp):.1f}%",
                    ha="center", va="bottom", fontsize=7)
        ax.set_ylabel("Relative L2 Error")
        ax.grid(axis="y", linestyle="--", alpha=0.4)
        ax.spines[["top", "right"]].set_visible(False)
        _save(fig, path)


def repetition_box(values: Dict[str, np.ndarray], ylabel: str, path: str):
    """Across-repetition distribution (RepeatedExperiment)."""
    plt = _pyplot()
    with plt.rc_context(_RC):
        fig, ax = plt.subplots(figsize=(3.5, 3))
        names = list(values)
        bp = ax.boxplot([values[n] for n in names], tick_labels=names,
                        patch_artist=True)
        for patch, name in zip(bp["boxes"], names):
            patch.set_facecolor(COLOR_SCHEME.get(name, "#888888"))
            patch.set_alpha(0.8)
        ax.set_ylabel(ylabel)
        ax.spines[["top", "right"]].set_visible(False)
        _save(fig, path)
