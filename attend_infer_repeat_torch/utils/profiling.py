"""Profiling: ``torch.profiler`` traces and step timing.

``trace(logdir)`` writes a Chrome/TensorBoard trace of the enclosed block
(the card's kernels too, where there is one); ``StepTimer`` measures
steady-state step walls, fenced with ``torch.cuda.synchronize`` on the
result's device, since PyTorch returns before the card has finished.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, annotate: Optional[str] = None):
    """Profile the enclosed block into a trace file under ``logdir``;
    ``annotate`` names the block in the trace.  Yields the profiler."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        record_function,
        tensorboard_trace_handler,
    )

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        if annotate:
            with record_function(annotate):
                yield prof
        else:
            yield prof


def _cuda_devices(tree, found=None) -> set:
    """The CUDA devices of the tensors in ``tree``."""
    found = set() if found is None else found
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


class StepTimer:
    """Wall-clock step timer with warm-up discard and device fencing."""

    def __init__(self, n_warmup: int = 3):
        self.n_warmup = n_warmup
        self._times = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Fence on ``result``'s devices (if given), then record the wall."""
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.n_warmup:
            self._times.append(dt)
        return dt

    @property
    def mean_s(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean_s if self._times else 0.0
