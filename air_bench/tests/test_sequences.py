"""The ``sequences`` traffic kind (Sequential AIR, ``train_seq.*`` cells)
on the CPU: its planted faults and the control fail the cell's limits at
tiny widths, and its five readers read the kind's traces alone."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from air_bench import layout
from air_bench.reference import compare
from air_bench.tests.conftest import tiny_cell
from air_bench.tests.test_program_spans import (DEVICE, SERVE_EVENTS,
                                                TRAIN_EVENTS, Prof, device)
from air_bench.yardstick import peaks, sqair_work
from air_bench.yardstick.trace import summarize

CELL = "train_seq.sqair_k5"
READERS = layout.metric_readers()
SEQ = ("mfu_pct.seq", "st_roofline_pct.seq", "device_idle_pct.seq",
       "device_ops_per_step.seq", "step_issue_us.seq")


@pytest.mark.parametrize("fault", ["no_relation", "disc_from_zero",
                                   "control"])
def test_sqair_fault_is_not_correct(fault):
    """The relation state zeroed, discovery's canvas started at zero and
    the reference one precision lower, each in the program's place."""
    cell = tiny_cell(CELL)
    kind, cpu, seed = layout.kind("sequences"), torch.device("cpu"), \
        2 ** 31 + 7
    if fault == "control":
        numbers = kind.control_numbers(cell, seed, cpu)
    else:
        numbers = kind.fault_numbers(cell, seed, cpu, fault)
    assert not compare.passed(compare.judge(numbers, cell["limits"])), numbers


def fake(kind, events, steps=4, wall_us=100.0):
    """A traced run of ``kind`` whose trace holds ``events``."""
    prof = Prof(events)
    cfg = layout.cell(CELL)["config_doc"]["config"]
    return SimpleNamespace(
        kind=kind, cfg=cfg, peaks=peaks.H100_SXM,
        sub=SimpleNamespace(prof=prof, wall_s=wall_us * 1e-6),
        traced={"steps": steps, "images": steps * 8},
        untraced={"images": 1024, "wall_s": 2.0},
        summary=summarize(prof, wall_us * 1e-6))


#: A trace with the program's spans and one ST kernel, 91-96 µs.
EVENTS = TRAIN_EVENTS + [device("void st_gather_kernel<float>(int)", 91, 96)]


@pytest.mark.parametrize("name", SEQ)
def test_seq_readers_read_nothing_for_the_other_kinds(name):
    for kind in ("chunks", "closed_loop"):
        assert READERS[name].read(fake(kind, EVENTS + SERVE_EVENTS)) is None


def test_seq_readers():
    r = fake("sequences", EVENTS)
    got = {name: READERS[name].read(r) for name in SEQ}
    # (40 + 20) µs of train.steps over 4 steps
    assert got["step_issue_us.seq"] == pytest.approx(15.0)
    # busy 5-15, 25-45, 60-90, 91-96 µs of 100
    assert got["device_idle_pct.seq"] == pytest.approx(35.0)
    assert got["device_ops_per_step.seq"] == pytest.approx(4 / 4)
    st = sum(sqair_work.train_step(r.cfg).values()) * 4 / 3.35e12
    assert got["st_roofline_pct.seq"] == pytest.approx(100 * st / 5e-6)
    assert got["mfu_pct.seq"] == pytest.approx(
        100 * 1024 * sqair_work.least_seconds(r.cfg, peaks.H100_SXM) / 2.0)


def test_seq_issue_needs_the_programs_spans():
    """A trace without the program's spans (a program without them) gives
    no host issue, and the others read no span."""
    bare = [e for e in EVENTS if not e.name().startswith("air.")]
    r = fake("sequences", bare)
    assert READERS["step_issue_us.seq"].read(r) is None
    assert READERS["device_idle_pct.seq"].read(r) == pytest.approx(35.0)
    assert READERS["st_roofline_pct.seq"].read(fake("sequences", DEVICE)) \
        is None


def test_sqair_work_counts_the_steps_work():
    """The FLOPs count every linear of both phases and the prior, the ST
    bytes the launches a step makes (151 forward, 147 backward at 10
    frames and 3 slots)."""
    cfg = layout.cell(CELL)["config_doc"]["config"]
    names = [n for n, *_ in sqair_work.linears(cfg)]
    assert len(names) == len(set(names))
    assert {"prop.temporal.ih", "prop.relation.hh", "prior.pres",
            "disc.lstm.ih", "disc.decoder.1", "prop.decoder.1"} <= set(names)
    by = sqair_work.per_sequence(cfg)
    assert set(by) == {"bfloat16", "float32"} and min(by.values()) > 0
    work = sqair_work.train_step(cfg)
    assert work["forward"] > 0 and work["backward"] > work["forward"] / 2
