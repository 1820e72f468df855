"""Profiling: ``torch.profiler`` traces and the program's host spans.

``trace(logdir)`` writes a Chrome/TensorBoard trace of the enclosed block
(the card's kernels too, where there is one).

``span(name)`` marks a stretch of the program's host path as a range
named ``air.<name>`` in the trace of whatever ``torch.profiler`` session
records at the time; the profiler is its only sink.  The ranges share
the trace's clock with the card's kernels, so an idle stretch of the
card can be put down to the span the host was in; nesting on the one
thread that issues a call ties a span to its request or chunk.  A range
is kept on the host: it puts no mark on the device's timeline (as a
user-scope ``record_function`` would, for the kernels it launches).
With no profiler recording, ``span`` returns one shared no-op context,
at the cost of one check.

Spans: ``graph.capture`` (a graph's warm-up runs and capture),
``graph.launch`` (a replay), ``graphs.lookup``, ``graphs.fill`` and
``graphs.copy_out`` (a ``GraphCache`` call), ``serve.infer`` and
``serve.noise`` (an infer request and its noise draw), ``train.steps``,
``train.prepare`` and ``train.seed`` (a call of K graphed train steps,
its inputs and each step's re-seeding), ``sqair.propagate``,
``sqair.discover`` and ``sqair.compact`` (a SQAIR frame's phases) and
``data.sequences`` (the synthesis of a batch of sequences).  A graph's
replay runs no Python, so spans inside a captured step show in eager and
capture traces alone.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

#: Prefix of the program's spans in a trace.
PREFIX = "air."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the host range ``air.<name>`` while a
    profiler records, and does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


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
