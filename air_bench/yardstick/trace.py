"""The traced sub-window and the reading of its device trace.

``SubWindow`` runs ``torch.profiler`` (CPU and CUDA activity) over a
bounded, steady part of a run's window: the units (train chunks or
requests) ``first .. first + count - 1``, fenced by a device sync on
both sides; ``wall_s`` is its length on the host clock.  ``summarize``
reads the trace: every device event (kernels, copies, memsets; not the
device-side marks of the benchmark's own spans), their union on the device's timeline (``busy_s``), kernel counts and time by
name, the spatial-transformer kernels' time (kernels whose function
name, past its return type and namespaces, starts with ``st_gather``),
and the longest idle gaps between device work, each named by the
innermost ``air_bench.`` host span and the innermost host operation that
cover it.
"""

from __future__ import annotations

import contextlib
import re
import time

#: Prefix of the benchmark's own host spans in a trace.
SPAN = "air_bench."
#: Kernels of the spatial transformer, by the start of their function's
#: name (after its return type and namespaces).
_ST = re.compile(r"(?:^|[\s:])st_gather\w*(?:[<(]|$)")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up_profiler(device) -> None:
    """Bring CUPTI up before any graph is captured, so that a trace sees
    a replayed graph's kernels one by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
    _sync(device)


class SubWindow:
    """The profiler over units ``first .. first + count - 1`` of a window
    (inactive unless ``enabled``).  ``first=None`` leaves it to ``arm``:
    a window that ends on the clock traces the units that follow its
    last, so that the profiler's start and stop stall nothing else."""

    def __init__(self, enabled: bool, first, count: int, device):
        self.enabled, self.first, self.count = enabled, first, count
        self.device = device
        self.prof = None
        self.wall_s = None       # from the first sync to the last
        self.session_s = None    # from before the profiler starts to after
        self._t = None           # it stops (the profiler's own cost too)

    @property
    def done(self) -> bool:
        return not self.enabled or self.wall_s is not None

    def arm(self, unit: int) -> None:
        """Trace from ``unit`` on, unless already set."""
        if self.first is None:
            self.first = unit

    def active(self, unit: int) -> bool:
        return self.enabled and self.first is not None \
            and self.first <= unit < self.first + self.count

    def before(self, unit: int) -> None:
        if self.enabled and unit == self.first:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._t0 = time.perf_counter()
            _sync(self.device)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._t = time.perf_counter()

    def after(self, unit: int) -> None:
        if self.active(unit) and unit == self.first + self.count - 1:
            _sync(self.device)
            self.wall_s = time.perf_counter() - self._t
            self.prof.__exit__(None, None, None)
            self.session_s = time.perf_counter() - self._t0

    def span(self, name: str, unit: int):
        """A named host span in the trace while ``unit`` is traced."""
        if not self.active(unit):
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN + name)


def _events(prof):
    """``(name, is_device, start_us, end_us)`` of every event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, end = e.start_ns() / 1e3, (e.start_ns()
                                               + e.duration_ns()) / 1e3
        else:
            start, end = e.start_us(), e.start_us() + e.duration_us()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start, end))
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def is_st(name: str) -> bool:
    """A spatial-transformer kernel: ``void (anonymous namespace)::
    st_gather_kernel<...>(...)`` and the like."""
    return _ST.search(name) is not None


def summarize(prof, wall_s: float, top: int = 10) -> dict:
    """What the trace of one sub-window says; see the module doc."""
    events = _events(prof)
    dev = sorted((s, e, n) for n, d, s, e in events
                 if d and e > s and not n.startswith(SPAN))
    kernels = [(n, e - s) for s, e, n in dev if not is_copy(n)]
    by_name = {}
    for n, us in kernels:
        by_name[n] = by_name.get(n, 0.0) + us * 1e-6
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    host = [(s, e, n) for n, d, s, e in events if not d]
    holes = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _)
                    in zip(merged[:-1], merged[1:])), reverse=True)[:top]
    gaps = []
    for us, e0, s1 in holes:
        mid = 0.5 * (e0 + s1)
        cover = sorted((e - s, n) for s, e, n in host if s <= mid <= e)
        span = next((n[len(SPAN):] for _, n in cover if n.startswith(SPAN)),
                    "outside a span")
        op = next((n for _, n in cover if not n.startswith(SPAN)), "idle")
        gaps.append((f"{span}: {op}", us * 1e-6))
    return {
        "wall_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "n_kernels": len(kernels),
        "n_device_events": len(dev),
        "st_kernel_s": sum(v for n, v in by_name.items() if is_st(n)),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": gaps,
    }
