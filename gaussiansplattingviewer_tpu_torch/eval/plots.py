"""Metric plotting (ref metrics/plot_blur.py, blur_plot_2.py, plot_sob.py).

Headless matplotlib (Agg) figures:
  * blur-score series with moving average and MAE/MAD annotations
    (plot_blur.py's moving-average view);
  * chunked-median comparison across datasets (blur_plot_2.py);
  * outlier-removal scores per AO threshold (plot_sob.py).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def moving_average(x, w: int = 9):
    x = np.asarray(x, np.float64)
    if len(x) < w:
        return x.copy()
    return np.convolve(x, np.ones(w) / w, mode="valid")


def plot_blur_scores(series: dict[str, list[float]], out_png: str,
                     window: int = 9) -> dict:
    """Blur-score curves + moving averages; returns {name: {mae, mad}}
    like the reference's printed stats (metrics/plot_blur.py)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    stats = {}
    for name, vals in series.items():
        vals = np.asarray(vals, np.float64)
        ax.plot(vals, alpha=0.35, label=f"{name}")
        ma = moving_average(vals, window)
        ax.plot(np.arange(len(ma)) + window // 2, ma, lw=2,
                label=f"{name} (MA{window})")
        med = np.median(vals)
        stats[name] = {
            "mae": float(np.mean(np.abs(vals - vals.mean()))),
            "mad": float(np.median(np.abs(vals - med))),
            "mean": float(vals.mean()),
            "median": float(med),
        }
    ax.set_xlabel("frame")
    ax.set_ylabel("blur score")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return stats


def plot_chunked_median(series: dict[str, list[float]], out_png: str,
                        chunk: int = 10) -> dict:
    """Chunked-median bars (ref metrics/blur_plot_2.py)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    out = {}
    for name, vals in series.items():
        vals = np.asarray(vals, np.float64)
        n_chunks = max(len(vals) // chunk, 1)
        meds = [
            float(np.median(vals[i * chunk : (i + 1) * chunk]))
            for i in range(n_chunks)
        ]
        ax.plot(meds, marker="o", ms=3, label=name)
        out[name] = meds
    ax.set_xlabel(f"chunk ({chunk} frames)")
    ax.set_ylabel("median blur")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out


def plot_outlier_scores(scores_by_threshold: dict, out_png: str) -> None:
    """Outlier-removal fractions per AO-mask threshold (ref
    metrics/plot_sob.py over statistical_outlier_removal.py outputs).

    scores_by_threshold: {threshold_label: [fraction_removed per frame]}.
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for label, fracs in scores_by_threshold.items():
        ax.plot(np.asarray(fracs) * 100.0, label=f"AO {label}")
    ax.set_xlabel("frame")
    ax.set_ylabel("% points removed")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
