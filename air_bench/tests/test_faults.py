"""A run whose timed path is broken underneath comes out not ``correct``.

Each cell, cut to a tiny width, runs on the CPU (the chip's look skipped)
with one fault planted in the program: a train step that leaves its
state unchanged, one that moves the baseline group alone, a loss taken
over half of the batch, a step's loss altered where it is produced, a
served answer altered where it is produced.  There is one chip, so no cell has an exchange between chips to
leave out.
"""

from __future__ import annotations

import dataclasses

import pytest

from air_bench import program
from air_bench.run import run_cell
from air_bench.tests.conftest import CELLS, tiny_cell

TRAIN = [c for c in CELLS if c.startswith("train.")]
SERVE = [c for c in CELLS if not c.startswith("train.")]


def _half(x):
    """``x`` with every batch-major tensor cut to its first half."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[:x.shape[0] // 2]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _half(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _unchanged(monkeypatch):
    from attend_infer_repeat_torch.train import state

    monkeypatch.setattr(state.Optimizer, "apply",
                        lambda self, grads, st, lr: None)


def _model_unchanged(monkeypatch):
    from attend_infer_repeat_torch.train import state

    apply = state.Optimizer.apply
    monkeypatch.setattr(
        state.Optimizer, "apply", lambda self, grads, st, lr: apply(
            self, grads, st, dict(lr, model=lr["model"] * 0)))


def _half_batch(monkeypatch):
    from attend_infer_repeat_torch.train import step

    loss = step.surrogate_loss
    monkeypatch.setattr(step, "surrogate_loss",
                        lambda outputs, **kw: loss(_half(outputs), **kw))


def _altered_loss(monkeypatch):
    from attend_infer_repeat_torch.train import step

    loss = step.surrogate_loss

    def altered(outputs, **kw):
        value, metrics = loss(outputs, **kw)
        return value * 1.01, metrics

    monkeypatch.setattr(step, "surrogate_loss", altered)


def _altered_answer(monkeypatch):
    air = program.air()
    make = air.make_infer_fn

    def make_altered(*args, **kw):
        infer = make(*args, **kw)

        def altered(*a, **k):
            out = dict(infer(*a, **k))
            out["z_where"] = out["z_where"].clone()
            out["z_where"][0] += 0.25
            return out

        altered.graphs = infer.graphs
        return altered

    monkeypatch.setattr(air, "make_infer_fn", make_altered)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _model_unchanged,
                                   _half_batch, _altered_loss])
def test_train_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line, _ = run_cell(tiny_cell(name), 2 ** 31 + 3, 0.2, False, "cpu")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_fault_is_not_correct(name, monkeypatch):
    _altered_answer(monkeypatch)
    line, _ = run_cell(tiny_cell(name), 2 ** 31 + 3, 0.2, False, "cpu")
    assert not line["correct"], line["checks"]
