"""Digit template bank: the single-digit images canvases are built from.

The bank is the UCI optical-recognition handwritten-digits set (1,797
8×8 images, pixel values 0–16) as scikit-learn bundles it, committed here
once as ``digits_8x8.npz`` so that no machine needs scikit-learn.  It is
bilinearly upsampled to the configured digit size, as the JAX package
upsamples the same images.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

BANK_PATH = Path(__file__).with_name("digits_8x8.npz")


def load_digit_bank(source: str = "auto", digit_size=(28, 28),
                    split: str = "train"):
    """``(images (N, h, w) float32 in [0, 1], labels (N,) int64)`` on the CPU.

    Deterministic 90/10 train/eval split.  Only the bundled bank
    (``source`` ``"auto"`` or ``"sklearn"``) is ported.
    """
    if source not in ("auto", "sklearn"):
        raise NotImplementedError(
            f"digit source {source!r}: only the bundled bank is ported")
    with np.load(BANK_PATH) as blob:
        imgs = torch.from_numpy(blob["images"].astype(np.float32) / 16.0)
        labels = torch.from_numpy(blob["labels"].astype(np.int64))
    n_eval = len(imgs) // 10
    if split == "train":
        imgs, labels = imgs[:-n_eval], labels[:-n_eval]
    else:
        imgs, labels = imgs[-n_eval:], labels[-n_eval:]
    # bilinear upsampling with half-pixel centers, as jax.image.resize
    # "linear" upsamples; then restore the contrast lost to smoothing
    up = F.interpolate(imgs[:, None], size=tuple(digit_size),
                       mode="bilinear", align_corners=False)[:, 0]
    return torch.clamp(up * 1.6, 0.0, 1.0), labels
