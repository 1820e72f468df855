"""PyTorch port: the tests of ``tests/test_utils.py`` (step timer, trace,
debug mode, functional checks) ported, the kernels' build cache and a
graph's launch counts."""

import collections
import json
import os

import pytest
import torch

from attend_infer_repeat_torch.utils import (
    StepTimer,
    checkify_fn,
    debug_mode,
    enable_compilation_cache,
    trace,
)
from attend_infer_repeat_torch.utils import debug

torch.set_num_threads(1)


def test_step_timer_measures():
    t = StepTimer(n_warmup=1)
    x = torch.ones((64, 64))
    for _ in range(4):
        t.start()
        t.stop({"y": x * 2.0, "rows": [x]})
    assert len(t._times) == 3
    assert t.mean_s > 0
    assert t.images_per_sec(64) > 0


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
                 "debug_mode", "checkify_fn", "trace", "StepTimer",
                 "enable_compilation_cache"):
        assert name in air.__all__


def test_graph_counts_launches_by_shape(monkeypatch):
    """A graph's capture adds no launch, since it executes nothing; each
    replay adds the launches of one captured run, by shape too."""
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.utils import graphs

    class PythonAtCaptureOnly(graphs.Graph):
        # as on the card: the capture runs the body's Python, a replay none
        def _capture(self, body, capture, generators):
            return body()

        def _replay(self):
            pass

    key = ("st_gather_bwd", 4, 20, 20, 50, 50)
    monkeypatch.setattr(st_kernel, "launches", 0)
    monkeypatch.setattr(st_kernel, "bwd_launches", 0)
    monkeypatch.setattr(st_kernel, "shape_launches", collections.Counter())

    def body():                     # counts as the kernel's wrapper does
        st_kernel.bwd_launches += 1
        st_kernel.shape_launches[key] += 1

    graph = PythonAtCaptureOnly(body, "cpu")
    assert graph.per_replay == (0, 1, collections.Counter({key: 1}))
    assert st_kernel.bwd_launches == st_kernel.shape_launches[key] == \
        graphs.WARMUP
    graph.launch()
    graph.launch()
    assert st_kernel.bwd_launches == st_kernel.shape_launches[key] == \
        graphs.WARMUP + 2
    assert st_kernel.launches == 0 and +st_kernel.shape_launches == \
        collections.Counter({key: graphs.WARMUP + 2})
