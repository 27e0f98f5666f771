"""Paper-figure plotting helpers, the twin of `mmd_tpu/viz/plotting.py`
(reference: mmd/plotting/base.py:13-136): figure and legend export, the
confidence ellipse and the confidence band of result figures. matplotlib
is imported inside the functions that need it."""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from mmd_torch.viz.visualizer import pyplot


def save_fig(fig, path: str, dpi: int = 200, tight: bool = True):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if tight:
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
    else:
        fig.savefig(path, dpi=dpi)


def export_legend(ax, path: str, ncol: int = 4, dpi: int = 200):
    """Save the axis legend as a figure of its own (reference: base.py)."""
    plt = pyplot()
    handles, labels = ax.get_legend_handles_labels()
    fig_leg = plt.figure()
    fig_leg.legend(handles, labels, ncol=ncol, loc="center", frameon=False)
    fig_leg.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig_leg)


def confidence_ellipse(x: np.ndarray, y: np.ndarray, ax, n_std: float = 2.0,
                       facecolor: str = "none", **kwargs):
    """Draw the n-sigma covariance ellipse of (x, y) samples
    (reference: base.py confidence_ellipse)."""
    pyplot()
    import matplotlib.transforms
    from matplotlib.patches import Ellipse

    if x.size != y.size:
        raise ValueError("x and y must be the same size")
    cov = np.cov(x, y)
    pearson = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    rx = np.sqrt(1 + pearson)
    ry = np.sqrt(1 - pearson)
    ellipse = Ellipse((0, 0), width=2 * rx, height=2 * ry,
                      facecolor=facecolor, **kwargs)
    scale_x = np.sqrt(cov[0, 0]) * n_std
    scale_y = np.sqrt(cov[1, 1]) * n_std
    transf = (matplotlib.transforms.Affine2D()
              .rotate_deg(45)
              .scale(scale_x, scale_y)
              .translate(np.mean(x), np.mean(y)))
    ellipse.set_transform(transf + ax.transData)
    ax.add_patch(ellipse)
    return ellipse


def plot_with_confidence_interval(ax, x: Sequence[float], ys: np.ndarray,
                                  label: Optional[str] = None, color=None,
                                  alpha_fill: float = 0.2):
    """Mean line and std band over trials: ys (n_trials, len(x))
    (reference: base.py confidence-interval helper)."""
    ys = np.asarray(ys)
    mean = ys.mean(axis=0)
    std = ys.std(axis=0)
    line, = ax.plot(x, mean, label=label, color=color)
    ax.fill_between(x, mean - std, mean + std, color=line.get_color(),
                    alpha=alpha_fill)
    return line
