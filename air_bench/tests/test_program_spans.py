"""The readers of the program's host spans, on small made-up traces:
exact values, and nothing for the other traffic kind or for a trace
without the program's spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from air_bench import layout
from air_bench.yardstick.trace import summarize

READERS = layout.metric_readers()
TRAIN = ("step_issue_us.train", "launch_idle_pct.train")
SERVE = ("host_path_us.serve", "host_path_idle_pct.serve")


class Event:
    def __init__(self, name, device, start_us, end_us):
        self._name, self._device = name, device
        self._start, self._end = start_us, end_us

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def start_ns(self):
        return int(self._start * 1000)

    def duration_ns(self):
        return int((self._end - self._start) * 1000)


def host(name, s, e):
    return Event(name, False, s, e)


def device(name, s, e):
    return Event(name, True, s, e)


class Prof:
    """What the readers take from ``torch.profiler.profile``."""

    def __init__(self, events):
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: list(events)))


def run(kind, events, wall_us=100.0, steps=None):
    prof = Prof(events)
    return SimpleNamespace(kind=kind, sub=SimpleNamespace(
        prof=prof, wall_s=wall_us * 1e-6), traced={"steps": steps},
        summary=summarize(prof, wall_us * 1e-6))


#: Device work 5-15, 25-45, 60-90 µs (holes 15-25, 45-60), with the
#: benchmark's own device mark and an empty event, which count for none.
DEVICE = [device("k0", 5, 15), device("k1", 25, 40), device("Memcpy", 30, 45),
          device("k2", 60, 90), device("air_bench.chunk", 0, 100),
          device("k3", 50, 50)]

TRAIN_EVENTS = DEVICE + [
    host("air_bench.chunk", 0, 95),
    host("air.train.steps", 0, 40), host("air.train.prepare", 0, 10),
    host("air.train.seed", 10, 12), host("air.graph.launch", 12, 21),
    host("cudaGraphLaunch", 13, 20.5),
    host("air.train.seed", 21, 22), host("air.graph.launch", 22, 30),
    host("air.train.steps", 50, 70), host("air.train.prepare", 50, 55),
    host("air.train.seed", 55, 56), host("air.graph.launch", 56, 58),
    host("air.train.seed", 58, 59), host("air.graph.launch", 59, 65)]

SERVE_EVENTS = DEVICE + [
    host("air.serve.infer", 0, 30), host("air.serve.noise", 0, 2),
    host("air.graphs.lookup", 2, 5), host("air.graphs.fill", 5, 8),
    host("air.graph.launch", 8, 20), host("air.graphs.copy_out", 20, 25),
    host("air.serve.infer", 40, 62), host("air.graph.launch", 45, 50)]


def test_train_readers():
    r = run("chunks", TRAIN_EVENTS, steps=4)
    # (40 + 20) µs of train.steps over 4 steps
    assert READERS["step_issue_us.train"].read(r) == pytest.approx(15.0)
    # launches 12-21, 22-30 in the hole 15-25: 6 + 3 µs; 56-58 and 59-65
    # in the hole 45-60: 2 + 1 µs; over 100 µs
    assert READERS["launch_idle_pct.train"].read(r) == pytest.approx(12.0)


def test_serve_readers():
    r = run("closed_loop", SERVE_EVENTS)
    # (30 - 12) and (22 - 5) µs
    assert READERS["host_path_us.serve"].read(r) == pytest.approx(17.5)
    # the request 0-30 holds the hole 15-25, the request 40-62 the hole
    # 45-60: 10 + 15 µs over 100 µs
    assert READERS["host_path_idle_pct.serve"].read(r) == pytest.approx(25.0)


def test_holes_are_the_summarys():
    """The holes the readers count are those ``summarize`` names."""
    from air_bench.yardstick import spans

    r = run("chunks", TRAIN_EVENTS, steps=4)
    holes = sorted((e - s for s, e in spans.of(r).holes), reverse=True)
    assert holes == pytest.approx([us * 1e6 for _, us in
                                   r.summary["idle_gaps"]])
    # a gap's name is the innermost host event the host was in: here a
    # program span, there the runtime call inside one
    assert [n for n, _ in r.summary["idle_gaps"]] == [
        "chunk: air.train.prepare", "chunk: cudaGraphLaunch"]


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_readers_read_nothing_elsewhere(name):
    """Nothing for the other traffic kind, nor for a trace that holds
    none of the program's spans (a program without them)."""
    other = "closed_loop" if name in TRAIN else "chunks"
    own = "chunks" if name in TRAIN else "closed_loop"
    events = TRAIN_EVENTS + SERVE_EVENTS
    assert READERS[name].read(run(other, events, steps=4)) is None
    bare = [e for e in events if not e.name().startswith("air.")]
    assert READERS[name].read(run(own, bare, steps=4)) is None
