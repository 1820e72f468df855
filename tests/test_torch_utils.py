"""PyTorch port: the tests of ``tests/test_utils.py`` (trace, debug
mode, functional checks) ported, the kernels' build cache, a graph's
launch counts and the program's host spans."""

import collections
import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.utils import (
    checkify_fn,
    debug_mode,
    enable_compilation_cache,
    span,
    trace,
)
from attend_infer_repeat_torch.utils import debug, graphs, profiling

torch.set_num_threads(1)


class PythonAtCaptureOnly(graphs.Graph):
    # as on the card: the capture runs the body's Python, a replay none
    def _capture(self, body, capture, generators):
        return body()

    def _replay(self):
        pass


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "prof")
    with trace(logdir, annotate="unit"):
        torch.ones(8) + 1
    found = [os.path.join(root, f) for root, _, files in os.walk(logdir)
             for f in files]
    assert found, "no profiler artifacts written"
    events = json.loads(open(found[0]).read())["traceEvents"]
    assert any(e.get("name") == "unit" for e in events)


def test_debug_mode_restores_config():
    before = torch.is_anomaly_enabled()
    assert not debug.active()
    with debug_mode(nans=True):
        assert torch.is_anomaly_enabled() and debug.active()
        with debug_mode(nans=False, disable_jit=True):
            assert debug.active()
        assert debug.active()
    assert torch.is_anomaly_enabled() == before
    assert not debug.active()


def test_debug_mode_traps_nan():
    """A NaN raises at the operation that makes it, in the forward and in
    the backward; uninitialized outputs are not read as NaN."""
    with debug_mode(nans=True):
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(4) - 1.0)
        torch.empty(1 << 16).fill_(0.0)
        x = torch.zeros(3, requires_grad=True)
        y = (x ** 0.5 * 0.0).sum()          # finite forward, 0 · inf below
        with pytest.raises(FloatingPointError):
            y.backward()
    assert torch.isnan(torch.log(torch.zeros(1) - 1.0)).all()


def test_checkify_reports_nan():
    checked = checkify_fn(torch.log)
    err, out = checked(torch.tensor([-1.0]))
    with pytest.raises(Exception):
        err.throw()
    err, out = checked(torch.tensor([1.0]))
    err.throw()  # no error
    assert err.get() is None
    torch.testing.assert_close(out, torch.zeros(1), atol=1e-7, rtol=0)
    err, _ = checkify_fn(lambda a, b: a / b)(torch.ones(2),
                                              torch.tensor([1.0, 0.0]))
    assert "division by zero" in err.get()


def test_enable_compilation_cache_moves_the_kernel_build(tmp_path,
                                                         monkeypatch):
    from attend_infer_repeat_torch.ops import st_kernel

    monkeypatch.setattr(st_kernel, "BUILD_DIR", st_kernel.BUILD_DIR)
    path = enable_compilation_cache(str(tmp_path / "kernels"))
    assert path == str(tmp_path / "kernels") and os.path.isdir(path)
    assert st_kernel.BUILD_DIR == tmp_path / "kernels"
    monkeypatch.delenv("AIR_TORCH_CACHE_DIR", raising=False)
    assert enable_compilation_cache() == str(st_kernel.DEFAULT_BUILD_DIR)


def test_package_exports_resolve():
    """Every lazy export of the port resolves, the new ``parallel`` and
    ``utils`` names among them."""
    import attend_infer_repeat_torch as air

    for name in air.__all__:
        assert getattr(air, name) is not None, name
    for name in ("make_mesh", "shard_batch", "make_shardmap_train_step",
                 "debug_mode", "checkify_fn", "trace",
                 "enable_compilation_cache"):
        assert name in air.__all__


def test_graph_counts_launches_by_shape(monkeypatch):
    """A graph's capture adds no launch, since it executes nothing; each
    replay adds the launches of one captured run, by shape too, and the
    LSTM kernels' (``modules.lstm_counts``) and a counter registered with
    ``graphs.carry`` as the ST kernels'."""
    from attend_infer_repeat_torch.models import modules
    from attend_infer_repeat_torch.ops import st_kernel

    module = sys.modules[__name__]

    key = ("st_gather_bwd", 4, 20, 20, 50, 50)
    monkeypatch.setattr(st_kernel, "launches", 0)
    monkeypatch.setattr(st_kernel, "bwd_launches", 0)
    monkeypatch.setattr(st_kernel, "shape_launches", collections.Counter())
    monkeypatch.setattr(modules, "lstm_counts", collections.Counter())
    monkeypatch.setattr(module, "carried", collections.Counter(),
                        raising=False)
    monkeypatch.setattr(graphs, "CARRIED", [])
    graphs.carry(__name__, "carried")
    graphs.carry(__name__, "carried")       # once only

    def body():                     # counts as the kernels' wrappers do
        st_kernel.bwd_launches += 1
        st_kernel.shape_launches[key] += 1
        modules.lstm_counts["fused"] += 1
        module.carried["cells"] += 256

    graph = PythonAtCaptureOnly(body, "cpu")
    assert graph.per_replay == (0, 1, collections.Counter({key: 1}),
                                collections.Counter({"fused": 1}),
                                collections.Counter({"cells": 256}))
    assert st_kernel.bwd_launches == st_kernel.shape_launches[key] == \
        modules.lstm_counts["fused"] == graphs.WARMUP
    graph.launch()
    graph.launch()
    assert st_kernel.bwd_launches == st_kernel.shape_launches[key] == \
        modules.lstm_counts["fused"] == graphs.WARMUP + 2
    assert st_kernel.launches == 0 and +st_kernel.shape_launches == \
        collections.Counter({key: graphs.WARMUP + 2})
    assert +modules.lstm_counts == collections.Counter(
        {"fused": graphs.WARMUP + 2})
    assert +module.carried == collections.Counter(
        {"cells": 256 * (graphs.WARMUP + 2)})


def test_only_the_graph_layer_chooses_eager():
    """``eager(...)`` is called in ``utils/graphs.py`` and in the train
    step's ``StepGraph`` only: every other entry point has one path, which
    its graph cache runs eagerly or replays."""
    import ast
    import pathlib

    import attend_infer_repeat_torch

    root = pathlib.Path(attend_infer_repeat_torch.__file__).parent
    seen, stray = set(), []
    for path in sorted(root.rglob("*.py")):
        where = path.relative_to(root).as_posix()
        tree = ast.parse(path.read_text())
        in_class = {n: cls.name for cls in ast.walk(tree)
                    if isinstance(cls, ast.ClassDef) for n in ast.walk(cls)}
        for call in ast.walk(tree):
            if isinstance(call, ast.Call) and "eager" in (
                    getattr(call.func, "id", None),
                    getattr(call.func, "attr", None)):
                at = (where, in_class.get(call))
                seen.add(at)
                if where != "utils/graphs.py" and \
                        at != ("train/step.py", "StepGraph"):
                    stray.append(f"{where}:{call.lineno}")
    assert not stray
    assert ("utils/graphs.py", "GraphCache") in seen
    assert ("train/step.py", "StepGraph") in seen


def test_step_graph_keeps_forwards_per_step(monkeypatch):
    """A K-step chunk of the ``iwae`` objective, one step's graph replayed
    K times: its warm-ups and capture run the step's Python and count, a
    replay counts nothing, so forwards over steps stays a step's one wide
    forward of its particles."""
    import dataclasses

    from attend_infer_repeat_torch.train import (
        create_train_state,
        make_scan_train_step,
    )
    from attend_infer_repeat_torch.train.step import objective_counts

    monkeypatch.setattr(graphs, "Graph", PythonAtCaptureOnly)
    monkeypatch.setattr(graphs, "eager", lambda device: False)
    k, cfg = 3, tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, objective="iwae", iwae_particles=2, use_baseline=False))
    state = create_train_state(cfg, seed=0, device="cpu")
    scan = make_scan_train_step(cfg, state.model, torch.rand((5, 4, 4)), k)
    before = collections.Counter(objective_counts)
    state, _ = scan(state)
    built = objective_counts - before
    assert built == collections.Counter(steps=graphs.WARMUP + 1,
                                        forwards=graphs.WARMUP + 1)
    state, _ = scan(state)
    assert objective_counts - before == built


# --- host spans -------------------------------------------------------------

def spans(prof) -> list:
    """The trace's ``air.`` host ranges in order of start, each indented
    by the ranges that hold it."""
    found = sorted((e.start_ns(), -e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(profiling.PREFIX))
    rows, ends = [], []
    for start, minus_length, name in found:
        while ends and ends[-1] <= start:
            ends.pop()
        rows.append("  " * len(ends) + name[len(profiling.PREFIX):])
        ends.append(start - minus_length)
    return rows


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


def tiny_config() -> tcfg.Config:
    return tcfg.Config(
        model=tcfg.ModelConfig(
            img_size=(12, 12), glimpse_size=(4, 4), n_what=3, max_steps=2,
            rnn_hidden=8, encoder_hidden=(8,), glimpse_encoder_hidden=(8,),
            decoder_hidden=(8,), transform_hidden=(8,), steps_hidden=(4,),
            baseline_hidden=(8,)),
        data=tcfg.DataConfig(canvas_size=(12, 12), digit_size=(4, 4)),
        train=tcfg.TrainConfig(batch_size=4))


def test_span_off_is_one_shared_noop():
    """With no profiler recording a span is the one no-op context, and a
    profiler that has not started yet records none of it."""
    assert span("a") is span("b") is profiling._OFF
    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=1),
                 on_trace_ready=lambda p: seen.append(spans(p))) as p:
        for name in ("waiting", "warming", "recording"):
            with span(name):
                torch.ones(2).add_(1)
            p.step()
    assert seen == [["recording"]]


def test_span_closes_when_its_body_raises():
    with recorded() as p:
        with pytest.raises(KeyError):
            with span("outer"):
                with span("inner"):
                    raise KeyError("x")
        with span("after"):
            pass
    assert spans(p) == ["outer", "  inner", "after"]


def test_graph_cache_spans(monkeypatch):
    """A call's lookup (the first holds the capture), fill, replay and
    copy of the outputs, in order."""
    monkeypatch.setattr(graphs, "Graph", PythonAtCaptureOnly)
    monkeypatch.setattr(graphs, "eager", lambda device: False)
    cache = graphs.GraphCache(lambda held, x: {"y": x * held})
    held, x = torch.full((3,), 2.0), torch.arange(3.0)
    with recorded() as p:
        first = cache(held, x)
        second = cache(held, x)
    assert spans(p) == ["graphs.lookup", "  graph.capture", "graphs.fill",
                        "graph.launch", "graphs.copy_out"] + [
        "graphs.lookup", "graphs.fill", "graph.launch", "graphs.copy_out"]
    assert torch.equal(first["y"], second["y"])
    assert first["y"] is not second["y"]


def test_step_graph_spans(monkeypatch):
    """A call of K graphed steps: its preparation, then each step's
    re-seeding and replay, all inside ``train.steps``; the first call
    captures the step before."""
    from attend_infer_repeat_torch.train import (
        create_train_state,
        make_scan_train_step,
    )

    monkeypatch.setattr(graphs, "Graph", PythonAtCaptureOnly)
    monkeypatch.setattr(graphs, "eager", lambda device: False)
    k, cfg = 3, tiny_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    scan = make_scan_train_step(cfg, state.model, torch.rand((5, 4, 4)), k)
    calls = []
    with recorded() as p:
        for _ in range(2):
            state, rows = scan(state)
            calls.append(rows["loss"].shape)
    steps = ["train.steps", "  train.prepare"] + [
        "  train.seed", "  graph.launch"] * k
    assert spans(p) == ["graph.capture"] + steps + steps
    assert calls == [(k,), (k,)] and state.step == 2 * k


@pytest.mark.parametrize("graphed", [True, False])
def test_infer_spans(monkeypatch, graphed):
    """A request: the noise draw, then the graph cache's spans, inside
    ``serve.infer``; an eager request shows the noise draw alone inside
    it (the cache runs the forward with no span)."""
    from attend_infer_repeat_torch.models.air import AIRModel
    from attend_infer_repeat_torch.serving import make_infer_fn

    if graphed:
        monkeypatch.setattr(graphs, "Graph", PythonAtCaptureOnly)
        monkeypatch.setattr(graphs, "eager", lambda device: False)
    cfg = tiny_config()
    infer = make_infer_fn(cfg, AIRModel(cfg.model, use_baseline=False,
                                        device="cpu"))
    imgs, gen = torch.rand((4, 12, 12)), torch.Generator().manual_seed(0)
    with recorded() as p:
        for _ in range(2):
            out = infer(imgs, gen)
    request = ["serve.infer", "  serve.noise"]
    if graphed:
        request += ["  graphs.lookup", "  graphs.fill", "  graph.launch",
                    "  graphs.copy_out"]
    first = list(request)
    if graphed:
        first.insert(3, "    graph.capture")
    assert spans(p) == first + request
    assert out["canvas"].shape == (4, 12, 12)
