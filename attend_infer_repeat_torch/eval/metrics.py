"""Multi-batch evaluation and scalar logging.

``evaluate`` averages an eval step over fixed batches; ``MetricsLogger``
appends JSONL rows, prints a line and, where TensorBoard is installed,
writes scalars.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Sequence

import torch

from attend_infer_repeat_torch.ops.math import seeded_generator


def host_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d metric tensors as floats, with one device-to-host copy."""
    if not metrics:
        return {}
    values = [torch.as_tensor(v) for v in metrics.values()]
    dev = next((v.device for v in values if v.device.type != "cpu"),
               torch.device("cpu"))
    host = torch.stack([v.to(dev, torch.float32) for v in values]).cpu()
    return dict(zip(metrics, host.tolist()))


def evaluate(eval_step: Callable, state, batches: Iterable,
             seed: Sequence[int]) -> Dict[str, float]:
    """Average eval metrics over ``batches`` of ``(imgs, nums)``.

    Batch ``i`` draws its noise from ``seeded_generator(dev, *seed, i)``.
    Every batch is queued before any result is read: the metrics stay on
    the device and come to the host in one copy.
    """
    dev = state.model.device
    rows = []
    for i, (imgs, nums) in enumerate(batches):
        metrics, _ = eval_step(state, imgs, nums,
                               seeded_generator(dev, *seed, i))
        rows.append(metrics)
    if not rows:
        return {}
    keys = list(rows[0])
    flat = host_scalars({f"{i}/{k}": r[k] for i, r in enumerate(rows)
                         for k in keys})
    return {k: sum(flat[f"{i}/{k}"] for i in range(len(rows))) / len(rows)
            for k in keys}


class MetricsLogger:
    """Append-only JSONL metrics log + stdout lines (+ TensorBoard if
    installed)."""

    def __init__(self, workdir: str, use_tensorboard: bool = True):
        os.makedirs(workdir, exist_ok=True)
        self._path = os.path.join(workdir, "metrics.jsonl")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(workdir, "tb"))
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train"):
        row = {"step": int(step), "wall_s": time.time() - self._t0,
               "split": prefix}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self._path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))
        keys = ("elbo", "log_likelihood", "kl_steps", "count_accuracy",
                "count_accuracy_mode", "expected_steps")
        brief = " ".join(f"{k}={metrics[k]:.4g}" for k in keys
                         if k in metrics)
        if not brief:  # e.g. the basin-gate record: print everything
            brief = " ".join(f"{k}={float(v):.4g}"
                             for k, v in metrics.items())
        print(f"[{prefix} {step}] {brief}", flush=True)

    def close(self):
        if self._tb is not None:
            self._tb.close()
