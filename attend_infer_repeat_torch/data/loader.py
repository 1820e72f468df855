"""Loaders: reference-format pickles and in-memory minibatching.

Pickles hold ``imgs`` (N, H, W) and ``nums`` (N,); ``InMemoryDataset``
is a numpy permutation iterator over them, and the train step moves each
batch to the device.  The on-device synthesis path (``synth.py``) needs
none of this.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Iterator, Tuple

import numpy as np


def load_data(path: str) -> dict:
    """Load a reference-format dataset pickle (``imgs`` + ``nums``)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    imgs = np.asarray(blob["imgs"], np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    out = {"imgs": imgs, "nums": np.asarray(blob["nums"], np.int32)}
    if "labels" in blob:
        out["labels"] = np.asarray(blob["labels"])
    return out


@dataclasses.dataclass
class InMemoryDataset:
    """Shuffled minibatcher over in-memory numpy arrays."""

    imgs: np.ndarray    # (N, H, W)
    nums: np.ndarray    # (N,)

    def __len__(self) -> int:
        return len(self.imgs)

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite iterator of ``(imgs, nums)`` minibatches; drops the
        ragged tail of each epoch."""
        rng = np.random.default_rng(seed)
        n = len(self.imgs)
        if batch_size > n:
            raise ValueError(
                f"batch_size {batch_size} > dataset size {n}: the "
                f"tail-dropping iterator would yield nothing and block "
                f"forever")
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for lo in range(0, n - batch_size + 1, batch_size):
                sel = order[lo:lo + batch_size]
                yield self.imgs[sel], self.nums[sel]


def auto_split(blob: dict, eval_fraction: float = 0.1,
               ) -> Tuple[InMemoryDataset, InMemoryDataset]:
    """Deterministic train/eval split of one dataset pickle: the last
    ``eval_fraction`` of the rows are held out for evaluation."""
    n = len(blob["imgs"])
    cut = n - int(n * eval_fraction)
    if cut <= 0 or cut >= n:
        raise ValueError(
            f"dataset has only {n} image(s) — too few to auto-split "
            f"{1 - eval_fraction:.0%}/{eval_fraction:.0%}; pass an "
            f"explicit validation pickle (--eval-data)")
    return (InMemoryDataset(blob["imgs"][:cut], blob["nums"][:cut]),
            InMemoryDataset(blob["imgs"][cut:], blob["nums"][cut:]))


def tensors_from_data(data: dict, batch_size: int, seed: int = 0,
                      shuffle: bool = True):
    """Reference-API shim: dataset dict → infinite minibatch iterator."""
    ds = InMemoryDataset(data["imgs"], data["nums"])
    return ds.batches(batch_size, seed=seed, shuffle=shuffle)


def batch_iterator(synth_fn, seed: int, batch_size: int, device=None):
    """Infinite iterator of synthesized batches from ``make_synth_fn``'s
    function.  Batch ``s`` draws from the data generator that train step
    ``s`` of a state with base seed ``seed`` uses (``step_generators``);
    ``device`` is the synthesis function's device (CUDA by default)."""
    from attend_infer_repeat_torch import resolve_device
    from attend_infer_repeat_torch.train.step import step_generators

    dev = resolve_device(device)
    step = 0
    while True:
        g_data, _ = step_generators(seed, step, dev)
        yield synth_fn(batch_size, g_data)
        step += 1
