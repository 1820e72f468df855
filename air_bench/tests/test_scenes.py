"""The ``scenes`` traffic kind (SPACE, ``train_scene.*`` cells) on the CPU:
its planted faults and the control fail the cell's limits at tiny widths,
its five readers read the kind's traces alone, and ``space_work`` counts a
step's work from the configuration."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from air_bench import layout
from air_bench.reference import compare
from air_bench.tests.conftest import tiny_cell
from air_bench.tests.test_program_spans import (DEVICE, SERVE_EVENTS,
                                                TRAIN_EVENTS, Prof, device)
from air_bench.yardstick import peaks, space_work
from air_bench.yardstick.st_bytes import gather, gather_bwd
from air_bench.yardstick.trace import summarize

CELL = "train_scene.space_g16"
READERS = layout.metric_readers()
SCENE = ("mfu_pct.scene", "st_roofline_pct.scene", "device_idle_pct.scene",
         "device_ops_per_step.scene", "step_issue_us.scene")


@pytest.mark.parametrize("fault", ["depth", "stick", "control"])
def test_space_fault_is_not_correct(fault):
    """γ without σ(−z_depth), π_K dropped, and the reference one precision
    lower, each in the program's place."""
    cell = tiny_cell(CELL)
    kind, cpu, seed = layout.kind("scenes"), torch.device("cpu"), \
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
        traced={"steps": steps, "images": steps * 32},
        untraced={"images": 320, "wall_s": 2.0},
        summary=summarize(prof, wall_us * 1e-6))


#: A trace with the program's spans and one indexed-gather kernel, 91-96 µs.
EVENTS = TRAIN_EVENTS + [device(
    "void (anonymous namespace)::st_gather_kernel<false, 4, 128, true>"
    "(float const*, float const*, float*, int, int, int, int, bool, "
    "int const*)", 91, 96)]


@pytest.mark.parametrize("name", SCENE)
def test_scene_readers_read_nothing_for_the_other_kinds(name):
    for kind in ("chunks", "closed_loop", "sequences"):
        assert READERS[name].read(fake(kind, EVENTS + SERVE_EVENTS)) is None


def test_scene_readers():
    r = fake("scenes", EVENTS)
    got = {name: READERS[name].read(r) for name in SCENE}
    # (40 + 20) µs of train.steps over 4 steps
    assert got["step_issue_us.scene"] == pytest.approx(15.0)
    # busy 5-15, 25-45, 60-90, 91-96 µs of 100
    assert got["device_idle_pct.scene"] == pytest.approx(35.0)
    assert got["device_ops_per_step.scene"] == pytest.approx(4 / 4)
    st = sum(space_work.train_step(r.cfg).values()) * 4 / 3.35e12
    assert got["st_roofline_pct.scene"] == pytest.approx(100 * st / 5e-6)
    assert got["mfu_pct.scene"] == pytest.approx(
        100 * 320 * space_work.per_scene(r.cfg) / 67e12 / 2.0)


def test_scene_issue_needs_the_programs_spans():
    """A trace without the program's spans gives no host issue, and one
    without an ST kernel no roofline."""
    bare = [e for e in EVENTS if not e.name().startswith("air.")]
    r = fake("scenes", bare)
    assert READERS["step_issue_us.scene"].read(r) is None
    assert READERS["device_idle_pct.scene"].read(r) == pytest.approx(35.0)
    assert READERS["st_roofline_pct.scene"].read(fake("scenes", DEVICE)) \
        is None


def test_space_work_counts_the_steps_work():
    """~20.7 GFLOP a scene's forward, two thirds and more of it the
    glimpse encoder and decoder over 256 cells; the ST bytes of 24,576
    indexed gathers (each of the 96 images read once), 32,768 pastes and
    the synthesis paste a step."""
    cfg = layout.cell(CELL)["config_doc"]["config"]
    ops = dict(space_work.layers(cfg))
    assert len(ops) == len(space_work.layers(cfg))
    fwd = sum(ops.values())
    assert 20e9 < fwd < 21.5e9
    glimpse = sum(f for n, f in ops.items() if n.startswith("fg.glimpse"))
    assert glimpse > 2 / 3 * fwd
    # one cell's first glimpse conv: 3 → 16, 3 × 3, at 32 × 32
    assert ops["fg.glimpse_enc.0"] == 256 * 2 * 3 * 9 * 16 * 32 * 32
    # the mask decoder's last block: 32 → 4·16, 3 × 3, at 64 × 64, K = 5
    assert ops["bg.mask_dec.blocks.6"] == 5 * 2 * 32 * 9 * 64 * 64 * 64
    assert space_work.per_scene(cfg) == 3 * fwd
    work = space_work.train_step(cfg)
    windows = 32 * 256 * 3
    images = 4 * 96 * 128 * 128
    assert work == {
        "forward": gather(32 * 24, (16, 16), (128, 128))
        + images + 4 * windows * (4 + 1 + 32 * 32)
        + gather(32 * 256 * 4, (32, 32), (128, 128)),
        "backward": images + 4 * windows * (4 + 1 + 32 * 32 + 4)
        + gather_bwd(32 * 256 * 4, (32, 32), (128, 128), True)}
    # the indexed gathers' bytes: the images once, not once a window
    assert space_work.indexed(96, windows, (128, 128), (32, 32), False) \
        < gather(windows, (128, 128), (32, 32)) / 10
