"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles each entry point into one XLA program, traced
once per static signature.  The port captures each as a CUDA graph, once
per signature, and replays it: the host launches one graph instead of
~1,700 operations.

``Graph`` captures one function of device tensors that outlive it.  It
first runs the function ``WARMUP`` times on the side stream that
``torch.cuda.graph`` shares across the process (so that every graph uses
one cuBLAS workspace), which loads the kernels and makes the cuBLAS and
autograd workspaces; the last run is under ``no_host_sync``, so an
operation that waits for the card raises there, named, instead of
breaking the capture.  Tensors the function writes in place (``state``)
are put back after the warm-up.  Capture runs the function's Python once
and executes nothing: the kernel wrappers' launch counts are put back,
and each replay adds the launches of one captured run.

``GraphCache`` keeps one ``Graph`` per signature (shapes, dtypes) of a
pure function's inputs: a call copies its inputs into the captured
graph's static buffers, replays it, and returns a copy of its outputs,
so that no later call overwrites what an earlier one returned.  The
tensors the graph reads by address (parameters, buffers, a digit bank)
are checked at each call: a call with other tensors raises, as does a
failed capture or replay.  Nothing falls back to eager.

``eager(device)`` is the one place that chooses between a graph and an
eager run: on the CPU, and inside ``utils.debug_mode`` (the counterpart
of ``jax_disable_jit``), ``GraphCache`` and the train step's
``StepGraph`` run their function eagerly and build no graph.  Each
entry point has one path either way: it draws its noise from the
caller's generator, then calls its cache, so that the CPU runs the
Python the card captures.  Only the train step keeps generators
registered with its graphs.

A body may issue ``torch.distributed`` collectives (a mesh entry point's
all-reduce and all-gather, the counterpart of ``jit`` over a ``Mesh``):
they are captured into the graph on NCCL's own stream, which forks from
and joins the capture stream, and each replay runs them again.  The first
warm-up run creates the NCCL communicator, which a capture could not.
The rule of such graphs: every rank of the group builds the same graphs
in the same order and replays them in the same order, so that each
warm-up run, capture and replay issues the same collectives on every
rank; a collective that one rank skips hangs the others.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import warnings
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from attend_infer_repeat_torch.utils.profiling import span

#: Eager runs of a function before it is captured.
WARMUP = 3


def eager(device) -> bool:
    """Whether a graph's function runs eagerly on ``device``: on anything
    but CUDA, and inside ``utils.debug_mode``."""
    from attend_infer_repeat_torch.utils import debug

    return torch.device(device).type != "cuda" or debug.active()


class _NameSyncs(TorchDispatchMode):
    """Name the ATen operation behind a "synchronizing CUDA operation"
    error of the sync debug mode."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            return func(*args, **(kwargs or {}))
        except RuntimeError as e:
            if "synchronizing" in str(e) and "CUDA graph" not in str(e):
                raise RuntimeError(
                    f"{func} waits for the card, which a CUDA graph cannot "
                    f"capture: {e}") from e
            raise


@contextlib.contextmanager
def no_host_sync():
    """Raise at any operation that waits for the card (a capture cannot
    wait), naming it, and the forward operation behind a backward one."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():        # "a prototype feature"
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False), \
                _NameSyncs():
            yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _launch_counts() -> tuple:
    """The kernels' launch counts: forward, backward, and by shape."""
    from attend_infer_repeat_torch.ops import st_kernel

    return (st_kernel.launches, st_kernel.bwd_launches,
            collections.Counter(st_kernel.shape_launches))


def _add_launches(counts: tuple, sign: int = 1) -> None:
    """Add ``counts`` (as ``_launch_counts`` gives them) to the kernels'
    launch counts, or take them away (``sign=-1``)."""
    from attend_infer_repeat_torch.ops import st_kernel

    st_kernel.launches += sign * counts[0]
    st_kernel.bwd_launches += sign * counts[1]
    if sign > 0:
        st_kernel.shape_launches.update(counts[2])
    else:
        st_kernel.shape_launches.subtract(counts[2])


class Graph:
    """``body()`` captured as one CUDA graph; ``launch()`` replays it.

    ``body`` reads and writes device tensors that outlive it and returns
    what it computes (``out``: the captured outputs, which each replay
    rewrites).  ``state``: tensors ``body`` writes in place, put back
    after the warm-up runs.  ``prepare(i)`` runs before warm-up run
    ``i``.  ``generators`` are registered with the graph (a replay
    draws from their state at that time).  ``pool_bytes``: the device
    memory the capture reserved, the graph's private pool.
    """

    def __init__(self, body: Callable, device, state: Sequence = (),
                 generators: Sequence = (),
                 prepare: Callable[[int], None] | None = None):
        self.device = torch.device(device)
        self.state = tuple(state)
        self.graph, capture = None, None
        if self.device.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(self.graph)
        with span("graph.capture"):
            self._warm_up(body, capture, state, prepare)
            counts = _launch_counts()
            if self.graph is not None:
                # as the capture does on entry, so that the memory reserved
                # after it, less that before, is the graph's own pool
                gc.collect()
                torch.cuda.empty_cache()
            reserved = self._reserved()
            try:
                self.out = self._capture(body, capture, generators)
            finally:
                after = _launch_counts()
                captured = (after[0] - counts[0], after[1] - counts[1],
                            after[2] - counts[2])
                _add_launches(captured, sign=-1)
        self.per_replay = captured
        self.pool_bytes = self._reserved() - reserved

    def _reserved(self) -> int:
        if self.graph is None:
            return 0
        return torch.cuda.memory_reserved(self.device)

    def _warm_up(self, body, capture, state, prepare) -> None:
        stream = None if capture is None else capture.capture_stream
        # no_grad: a copy tracked by autograd would make the parameters'
        # AccumulateGrad nodes on this stream, which capture may not sync
        with torch.no_grad():
            saved = [t.clone() for t in state]
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                for i in range(WARMUP):
                    if prepare is not None:
                        prepare(i)
                    last = i == WARMUP - 1 and stream is not None
                    with no_host_sync() if last else contextlib.nullcontext():
                        body()
        finally:
            if stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(stream)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)

    def _capture(self, body, capture, generators):
        for g in generators:
            self.graph.register_generator_state(g)
        try:
            with capture:
                return body()
        except BaseException:
            # a failed capture leaves the generators it drew from in capture
            # mode: give them fresh states with the same seeds and offsets
            index = self.device.index
            default = torch.cuda.default_generators[
                torch.cuda.current_device() if index is None else index]
            for g in (default, *generators):
                g.graphsafe_set_state(g.clone_state())
            raise

    def _replay(self) -> None:
        self.graph.replay()

    def launch(self):
        """Replay once; returns ``out``."""
        with span("graph.launch"):
            self._replay()
            _add_launches(self.per_replay)
        return self.out


def leaves(x) -> list:
    """The tensors of a nest of tuples, lists, dicts and dataclasses, in
    order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if x is None:
        return []
    raise TypeError(f"a graph input must be a tensor, or tuples, lists and "
                    f"dicts of them; got {type(x).__name__}")


def signature(x):
    """A hashable description of a nest of tensors: its structure, and
    each tensor's shape and dtype."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in x.items())
    if isinstance(x, (tuple, list)):
        return tuple(signature(v) for v in x)
    return x


def _map(fn, x):
    """``fn`` of every tensor in a nest of tuples, lists, dicts and
    dataclasses; anything else is kept as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


def static_like(x, device):
    """Static buffers on ``device`` for a nest of tensors, filled with
    its values (``fill``)."""
    static = _map(lambda v: torch.empty(v.shape, dtype=v.dtype,
                                        device=device), x)
    fill(static, x)
    return static


def copy(x):
    """A copy of every tensor in a nest of tuples, lists, dicts and
    dataclasses; anything else is kept as it is."""
    return _map(torch.clone, x)


def fill(static, values) -> None:
    """Copy a nest of tensors into static buffers of the same signature
    (a host tensor from pinned memory, asynchronously)."""
    for s, v in zip(leaves(static), leaves(values)):
        if v.device.type == "cpu" and s.device.type == "cuda":
            v = v.pin_memory()
        s.copy_(v, non_blocking=True)


def _held(held) -> list:
    if isinstance(held, torch.nn.Module):
        return [*held.parameters(), *held.buffers()]
    return leaves(held)


def addresses(tensors):
    """What a graph holds of ``tensors``: each one and its data pointer."""
    return [(t, t.data_ptr()) for t in tensors]


def check_held(captured, tensors, what: str = "tensors") -> None:
    """Raise unless ``tensors`` are the captured ones, at the same
    addresses (``addresses``)."""
    tensors = list(tensors)
    if len(tensors) != len(captured) or any(
            t is not c or t.data_ptr() != p
            for t, (c, p) in zip(tensors, captured)):
        raise ValueError(f"the {what} are not the ones the graph was "
                         f"captured with (restore in place)")


@dataclasses.dataclass
class _Entry:
    static: object          # the inputs' static buffers
    graph: Graph
    held: list              # addresses of the held tensors


class GraphCache(dict):
    """``fn(held, *inputs)`` captured once per signature of ``inputs``.

    ``held``: what the function reads by address (a module, whose
    parameters and buffers count, a dict or a tensor), on the device the
    graph runs on; ``inputs``: nests of tuples, lists and dicts of
    tensors (``None`` stays ``None``), copied into the graph's static
    buffers on that device at each call.  Maps each signature to its
    ``_Entry`` (``.graph``: the ``Graph``).  Where ``eager`` holds, a
    call runs ``fn`` on the inputs moved to that device, and builds and
    checks nothing.
    """

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def _run(self, held, inputs):
        """``fn(held, *inputs)``, and whether it came from a replay (the
        graph's static outputs, which the next replay rewrites)."""
        tensors = _held(held)
        device = tensors[0].device
        if eager(device):
            out = self.fn(held, *_map(lambda t: t.to(device), inputs))
            return out, False
        with span("graphs.lookup"):
            key = signature(inputs)
            entry = self.get(key)
            if entry is None:
                static = static_like(inputs, device)
                graph = Graph(lambda: self.fn(held, *static), device)
                entry = self[key] = _Entry(static, graph, addresses(tensors))
            else:
                check_held(entry.held, tensors, "parameters")
        with span("graphs.fill"):       # a miss's build filled them too
            fill(entry.static, inputs)
        return entry.graph.launch(), True

    def replay(self, held, *inputs):
        """Replay the graph of ``inputs``' signature (captured at its
        first call); returns its static outputs, which the next replay
        rewrites."""
        return self._run(held, inputs)[0]

    def __call__(self, held, *inputs):
        """``replay``, with a copy of the outputs that no call rewrites."""
        out, replayed = self._run(held, inputs)
        if not replayed:
            return out
        with span("graphs.copy_out"):
            return copy(out)
