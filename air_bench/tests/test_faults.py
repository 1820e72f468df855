"""A run whose timed path is broken underneath comes out not ``correct``.

Each cell, cut to a tiny width, runs on the CPU (the chip's look skipped)
with one fault planted in the program.  Train cells (traffic kind
``chunks``), by the configuration's objective (``TRAIN_FAULTS``): a step
that leaves its state unchanged, a loss taken over half of the batch, a
step's loss altered where it is produced; under ``elbo`` a step that
moves the baseline group alone; under ``iwae`` (VIMCO) each particle's
advantage without its leave-one-out baseline, and the particles' mean log
weight in place of the bound.  Serving cells (``closed_loop``): a served
answer altered where it is produced.  There is one chip, so no cell has
an exchange between chips to leave out.
"""

from __future__ import annotations

import dataclasses
import math

import pytest

from air_bench import layout, program
from air_bench.run import run_cell
from air_bench.tests.conftest import CELLS, KINDS, tiny_cell

TRAIN = [c for c in CELLS if KINDS[c] == "chunks"]
SERVE = [c for c in CELLS if KINDS[c] == "closed_loop"]


def _half(x):
    """``x`` with every batch-major tensor cut to its first half."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[:x.shape[0] // 2]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _half(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _unchanged(monkeypatch, objective):
    from attend_infer_repeat_torch.train import state

    monkeypatch.setattr(state.Optimizer, "apply",
                        lambda self, grads, st, lr: None)


def _model_unchanged(monkeypatch, objective):
    from attend_infer_repeat_torch.train import state

    apply = state.Optimizer.apply
    monkeypatch.setattr(
        state.Optimizer, "apply", lambda self, grads, st, lr: apply(
            self, grads, st, dict(lr, model=lr["model"] * 0)))


def _patch_loss(monkeypatch, objective, wrap):
    """Put ``wrap(clean)`` in the place of the objective's loss in the
    program's step: ``surrogate_loss(outputs, **kw)`` under ``elbo``,
    ``vimco_surrogate_loss(log_w, log_q)`` (both ``(k, B)``) under
    ``iwae``."""
    from attend_infer_repeat_torch.train import step

    name = "vimco_surrogate_loss" if objective == "iwae" else "surrogate_loss"
    monkeypatch.setattr(step, name, wrap(getattr(step, name)))


def _half_batch(monkeypatch, objective):
    def wrap(loss):
        if objective == "iwae":
            return lambda *lw_lq: loss(*(t[:, :t.shape[1] // 2]
                                         for t in lw_lq))
        return lambda outputs, **kw: loss(_half(outputs), **kw)
    _patch_loss(monkeypatch, objective, wrap)


def _altered_loss(monkeypatch, objective):
    def wrap(loss):
        def altered(*args, **kw):
            value, metrics = loss(*args, **kw)
            return value * 1.01, metrics
        return altered
    _patch_loss(monkeypatch, objective, wrap)


def _iwae_bound(log_w):
    import torch

    return torch.logsumexp(log_w, 0) - math.log(log_w.shape[0])


def _vimco(bound, loo: bool):
    """A VIMCO loss with the bound ``bound`` and, unless ``loo`` is
    false, the leave-one-out baselines under that bound; the metrics stay
    the program's."""
    import torch

    def wrap(loss):
        def vimco(log_w, log_q):
            _, metrics = loss(log_w, log_q)
            b = bound(log_w)
            baselines = 0.0
            if loo:
                k = log_w.shape[0]
                others = (torch.sum(log_w, 0)[None] - log_w) / (k - 1)
                baselines = torch.stack([
                    bound(torch.cat([log_w[:j], others[j:j + 1],
                                     log_w[j + 1:]])) for j in range(k)])
            advantage = (b[None] - baselines).detach()
            return torch.mean(-b - torch.sum(advantage * log_q, 0)), metrics
        return vimco
    return wrap


def _no_loo(monkeypatch, objective):
    _patch_loss(monkeypatch, objective, _vimco(_iwae_bound, loo=False))


def _elbo_mean(monkeypatch, objective):
    _patch_loss(monkeypatch, objective, _vimco(lambda w: w.mean(0), loo=True))


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


#: The program's faults that a train cell of each objective can have.
TRAIN_FAULTS = {
    "elbo": [_unchanged, _model_unchanged, _half_batch, _altered_loss],
    "iwae": [_unchanged, _half_batch, _altered_loss, _no_loo, _elbo_mean],
}


def objective(cell: dict) -> str:
    return cell["config_doc"]["config"]["train"]["objective"]


def _train_cases():
    cases = []
    for name in TRAIN:
        for fault in TRAIN_FAULTS[objective(layout.cell(name))]:
            cases.append(pytest.param(name, fault,
                                      id=f"{fault.__name__}-{name}"))
    return cases


@pytest.mark.parametrize("name, fault", _train_cases())
def test_train_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    fault(monkeypatch, objective(cell))
    line, _ = run_cell(cell, 2 ** 31 + 3, 0.2, False, "cpu")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_fault_is_not_correct(name, monkeypatch):
    _altered_answer(monkeypatch)
    line, _ = run_cell(tiny_cell(name), 2 ** 31 + 3, 0.2, False, "cpu")
    assert not line["correct"], line["checks"]
