"""The program's own host spans in a traced sub-window's trace, and the
card's idle holes that fall inside them.

The program marks its host path with ranges named ``air.<name>`` (its
``utils/profiling.py`` ``span``), on the trace's clock: ``train.steps``
(a call of K graphed train steps), ``graph.launch`` (one replay),
``serve.infer`` (one request) and their parts.  A program without them
leaves every reading here empty, and the metrics that read them are then
absent.  Holes are the idle stretches between device work, found as
``trace.summarize`` finds them: device events other than the benchmark's
own marks, merged where they overlap, and the gaps between them.
"""

from __future__ import annotations

import functools

from air_bench.yardstick.trace import SPAN, _events

#: Prefix of the program's spans in a trace.
PREFIX = "air."


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length both sorted lists of disjoint intervals cover."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Spans:
    """The program's spans (µs intervals by name, without the prefix)
    and the card's idle holes (µs) in one trace."""

    def __init__(self, prof):
        self.ranges, dev = {}, []
        for name, is_device, s, e in _events(prof):
            if is_device:
                if e > s and not name.startswith(SPAN):
                    dev.append((s, e))
            elif name.startswith(PREFIX):
                self.ranges.setdefault(name[len(PREFIX):], []).append((s, e))
        busy = _merge(dev)
        self.holes = [[e0, s1] for (_, e0), (s1, _) in zip(busy[:-1],
                                                           busy[1:])]

    def total_us(self, name: str) -> float:
        return sum(e - s for s, e in self.ranges.get(name, ()))

    def idle_in_us(self, name: str) -> float:
        """Hole time while the host is inside a ``name`` span."""
        return _overlap(self.holes, _merge(self.ranges.get(name, ())))

    def self_us(self, name: str, child: str) -> list:
        """Each ``name`` span's length less that of the ``child`` spans
        it holds."""
        kids = _merge(self.ranges.get(child, ()))
        return [(e - s) - _overlap([[s, e]], kids)
                for s, e in sorted(self.ranges.get(name, ()))]


@functools.lru_cache(maxsize=1)
def _read(prof) -> Spans:
    return Spans(prof)


def of(r) -> Spans:
    """The spans of run ``r``'s traced sub-window (read once a trace)."""
    return _read(r.sub.prof)
