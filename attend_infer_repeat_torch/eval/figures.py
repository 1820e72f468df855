"""Reconstruction + attention-box figures.

Draws, for a few examples: the input image, the model's reconstruction,
and one colored rectangle per inference step showing where the model
attended (decoded from ``z_where``), solid for present steps and dotted
for absent ones.  Host-side matplotlib, imported when a figure is drawn:
matplotlib is an optional viewer, and a machine without it trains all
the same (the loop turns figures off once).
"""

from __future__ import annotations

import os

import numpy as np

_COLORS = ["tab:red", "tab:green", "tab:cyan", "tab:orange", "tab:pink",
           "tab:purple"]


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _box_from_where(z_where, img_hw):
    """Axis-aligned attention rectangle in pixel coords.

    The gather samples image coords ``x = sx·u + tx`` for glimpse coords
    ``u ∈ [-1, 1]``, so the window spans ``[tx − |sx|, tx + |sx|]``
    normalized → pixels.
    """
    h, w = img_hw
    sx, sy, tx, ty = z_where
    x0 = (tx - abs(sx) + 1.0) * (w - 1) / 2.0
    x1 = (tx + abs(sx) + 1.0) * (w - 1) / 2.0
    y0 = (ty - abs(sy) + 1.0) * (h - 1) / 2.0
    y1 = (ty + abs(sy) + 1.0) * (h - 1) / 2.0
    return x0, y0, x1 - x0, y1 - y0


def make_fig(imgs, outputs, path: str, n_samples: int = 8,
             true_nums=None, max_scale=None) -> str:
    """Save an input/reconstruction grid with per-step attention boxes.

    ``imgs (B, H, W)`` and ``true_nums`` are numpy arrays or tensors;
    ``outputs`` is an ``AIROutputs``.  Pass the model's ``max_scale`` so
    that the boxes show the capped windows the model attends with.
    Returns the saved path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    imgs = _numpy(imgs)
    canvas = _numpy(outputs.canvas)
    z_where = _numpy(outputs.steps.z_where).copy()       # (B, T, 4)
    if max_scale is not None:
        z_where[..., :2] = np.minimum(z_where[..., :2], max_scale)
    pres = _numpy(outputs.steps.pres)                    # (B, T)
    pred_n = _numpy(outputs.predicted_steps)

    n = min(n_samples, imgs.shape[0])
    t_steps = z_where.shape[1]
    hw = imgs.shape[-2:]

    fig, axes = plt.subplots(2, n, figsize=(1.6 * n, 3.4))
    if n == 1:
        axes = axes.reshape(2, 1)
    for j in range(n):
        for row, im in ((0, imgs[j]), (1, canvas[j])):
            ax = axes[row, j]
            ax.imshow(im, cmap="gray", vmin=0.0, vmax=1.0)
            ax.set_xticks([])
            ax.set_yticks([])
            for t in range(t_steps):
                x, y, bw, bh = _box_from_where(z_where[j, t], hw)
                on = pres[j, t] > 0.5
                ax.add_patch(Rectangle(
                    (x, y), bw, bh, fill=False, linewidth=1.2,
                    linestyle="-" if on else ":",
                    alpha=1.0 if on else 0.35,
                    edgecolor=_COLORS[t % len(_COLORS)]))
        title = f"n̂={int(pred_n[j])}"
        if true_nums is not None:
            title += f"/{int(_numpy(true_nums)[j])}"
        axes[0, j].set_title(title, fontsize=8)
    axes[0, 0].set_ylabel("input", fontsize=8)
    axes[1, 0].set_ylabel("recon", fontsize=8)
    fig.tight_layout(pad=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
