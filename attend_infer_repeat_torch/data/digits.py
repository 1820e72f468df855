"""Digit template banks: the single-digit images canvases are built from.

The default bank is the UCI optical-recognition handwritten-digits set
(1,797 8×8 images, pixel values 0–16) as scikit-learn bundles it,
committed here once as ``digits_8x8.npz`` so that no machine needs
scikit-learn.  It is bilinearly upsampled to the configured digit size,
as the JAX package upsamples the same images.  Real MNIST (an ``.npz``
with ``images``/``labels``, or the reference's pickle format) is read
from a file with ``source="mnist:<path>"``; nothing is downloaded.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

BANK_PATH = Path(__file__).with_name("digits_8x8.npz")


def load_digit_bank(source: str = "auto", digit_size=(28, 28),
                    split: str = "train"):
    """``(images (N, h, w) float32 in [0, 1], labels (N,) int64)`` on the CPU.

    ``source``:
      - ``"auto"`` / ``"sklearn"``: the bundled bank, bilinearly upsampled
        to ``digit_size``;
      - ``"mnist:<path>"``: ``<path>`` is an ``.npz`` with ``images``
        (N, 28, 28 uint8 or float) and ``labels``, or a pickle with the
        reference's keys (``imgs``, optional ``labels``).
    Both take a deterministic 90/10 train/eval tail split.
    """
    if source in ("auto", "sklearn"):
        return _bundled_bank(digit_size, split)
    if source.startswith("mnist:"):
        return _file_bank(source[len("mnist:"):], digit_size, split)
    raise ValueError(f"unknown digit source {source!r}")


def _split(imgs, labels, n_eval, split):
    if split == "train":
        return imgs[:-n_eval], labels[:-n_eval]
    return imgs[-n_eval:], labels[-n_eval:]


def _bundled_bank(digit_size, split):
    with np.load(BANK_PATH) as blob:
        imgs = torch.from_numpy(blob["images"].astype(np.float32) / 16.0)
        labels = torch.from_numpy(blob["labels"].astype(np.int64))
    imgs, labels = _split(imgs, labels, len(imgs) // 10, split)
    # bilinear upsampling with half-pixel centers, as jax.image.resize
    # "linear" upsamples; then restore the contrast lost to smoothing
    up = F.interpolate(imgs[:, None], size=tuple(digit_size),
                       mode="bilinear", align_corners=False)[:, 0]
    return torch.clamp(up * 1.6, 0.0, 1.0), labels


def _file_bank(path, digit_size, split="train"):
    if path.endswith(".npz"):
        with np.load(path) as blob:
            imgs = np.asarray(blob["images"], np.float32)
            labels = np.asarray(blob["labels"], np.int64)
    else:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        imgs = np.asarray(blob["imgs"], np.float32)
        labels = np.asarray(blob.get("labels", np.zeros(len(imgs))),
                            np.int64)
    # eval canvases use held-out digits
    imgs, labels = _split(imgs, labels, max(len(imgs) // 10, 1), split)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    imgs, labels = torch.from_numpy(imgs), torch.from_numpy(labels)
    if tuple(imgs.shape[-2:]) != tuple(digit_size):
        # jax.image.resize "linear" widens its triangle filter when it
        # downsamples (antialias); F.interpolate does so only when asked
        imgs = F.interpolate(imgs[:, None], size=tuple(digit_size),
                             mode="bilinear", align_corners=False,
                             antialias=True)[:, 0]
    return imgs.contiguous(), labels
