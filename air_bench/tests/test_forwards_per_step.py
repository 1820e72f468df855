"""The reader of the program's objective counter: the forwards a step of
an ``iwae`` train cell runs, nothing elsewhere, and nothing from a
program without the counter."""

from __future__ import annotations

import collections
from types import SimpleNamespace

import pytest

from air_bench import layout

READ = layout.metric_readers()["forwards_per_step.train"].read


def run(kind="chunks", objective="iwae"):
    return SimpleNamespace(kind=kind, cfg={"train": {"objective": objective}})


def test_forwards_over_steps(monkeypatch):
    from attend_infer_repeat_torch.train import step

    monkeypatch.setattr(step, "objective_counts", collections.Counter(
        steps=103, forwards=515))
    assert READ(run()) == 5.0


@pytest.mark.parametrize("kind, objective", [("closed_loop", "iwae"),
                                             ("chunks", "elbo")])
def test_nothing_elsewhere(monkeypatch, kind, objective):
    from attend_infer_repeat_torch.train import step

    monkeypatch.setattr(step, "objective_counts", collections.Counter(
        steps=1, forwards=1))
    assert READ(run(kind, objective)) is None


def test_nothing_without_the_counter(monkeypatch):
    from attend_infer_repeat_torch.train import step

    monkeypatch.delattr(step, "objective_counts")
    assert READ(run()) is None
    monkeypatch.setattr(step, "objective_counts", collections.Counter(),
                        raising=False)
    assert READ(run()) is None
