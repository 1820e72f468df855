"""A cell, a configuration and a per-layer metric added as new files are
found by the harness, with no file that is there edited.  A cell of the
VIMCO objective (``iwae``) is two data files: its configuration and its
workload.  A traffic kind owns its calibration and its tiny cut, so a cell
of a new kind is new files too: ``traffic/<kind>.py``, its traffic
document and its workload."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from air_bench import calibrate, layout
from air_bench.reference import compare
from air_bench.reference import train as rtrain
from air_bench.run import run_cell
from air_bench.tests.conftest import CELLS, iwae_trained, tiny_cell, \
    tiny_config
from air_bench.tests.test_faults import TRAIN_FAULTS
from air_bench.yardstick import weights

_RUN = """
import json, sys
from air_bench import layout
from air_bench.run import run_cell
line, _ = run_cell(layout.cell(sys.argv[1]), 5, 0.2, True, "cpu")
print(json.dumps(line))
"""


def _copy(tmp_path):
    """A copy of the harness under ``tmp_path`` and its files' bytes."""
    root = tmp_path / "air_bench"
    shutil.copytree(layout.ROOT, root,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return root, {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def _run_from(tmp_path, cell: str) -> dict:
    """The result line of a traced run of ``cell`` from the copy under
    ``tmp_path``, in a process of its own."""
    env_path = str(tmp_path) + ":" + str(layout.ROOT.parent)
    out = subprocess.run([sys.executable, "-c", _RUN, cell], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_new_files_are_found(tmp_path):
    root, before = _copy(tmp_path)
    doc = layout.load("configs", "canonical_fast")
    doc = dict(doc, config=tiny_config(doc["config"]))
    (root / "configs" / "tiny_fast.json").write_text(json.dumps(doc))
    (root / "workloads" / "train.tiny_fast.json").write_text(json.dumps(
        dict(layout.load("workloads", "train.canonical_fast"),
             config="tiny_fast")))
    (root / "traffic" / "train_quick.json").write_text(json.dumps(
        dict(layout.load("traffic", "train"), trace_chunks=2)))
    (root / "metrics" / "steps_traced.train.py").write_text(
        'UNIT = "steps"\n\n\ndef read(r):\n'
        '    return r.traced.get("steps")\n')
    cell = layout.cell("train.tiny_fast", root)
    assert cell["config_doc"]["config"]["model"]["rnn_hidden"] == 8
    assert layout.load("traffic", "train_quick", root)["trace_chunks"] == 2
    assert "steps_traced.train" in layout.metric_readers(root)

    line = _run_from(tmp_path, "train.tiny_fast")
    assert line["correct"]
    assert line["metrics"]["steps_traced.train"]["value"] == 4
    for p, data in before.items():
        assert p.read_bytes() == data, p


def iwae_files(root) -> None:
    """Add a VIMCO cell as two files: ``configs/iwae_trained.json``, the
    ``iwae_trained`` preset (``canonical_fast``'s file with the objective
    ``iwae``, no baseline and a 5-particle eval) at tiny widths, and
    ``workloads/train.tiny_iwae.json``, ``train.canonical_fast``'s limits
    with ``baseline_mse`` dropped and ``iwae_bound`` at ``loss``'s."""
    doc = layout.load("configs", "canonical_fast")
    cfg = iwae_trained(tiny_config(doc["config"]))
    (root / "configs" / "iwae_trained.json").write_text(json.dumps(
        dict(doc, preset="iwae_trained", config=cfg)))
    cell = layout.load("workloads", "train.canonical_fast")
    limits = {k: v for k, v in cell["limits"].items()
              if not k.startswith("baseline_mse")}
    limits.update({k.replace("loss", "iwae_bound"): v
                   for k, v in cell["limits"].items()
                   if k.startswith("loss")})
    (root / "workloads" / "train.tiny_iwae.json").write_text(json.dumps(
        dict(cell, config="iwae_trained", limits=limits)))


@pytest.fixture(scope="module")
def iwae_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("iwae")
    root, before = _copy(tmp)
    iwae_files(root)
    return tmp, root, before


def test_an_iwae_cell_is_two_files(iwae_root):
    tmp, root, before = iwae_root
    line = _run_from(tmp, "train.tiny_iwae")
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert {"iwae_bound_gap.1", "iwae_bound_gap.3"} <= set(checks)
    assert not any(k.startswith("baseline_mse") for k in checks)
    for key, check in checks.items():
        assert check["value"] < 1e-5, (key, check)
    assert "setup_s" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    for p, data in before.items():
        assert p.read_bytes() == data, p
    added = {p.relative_to(root).as_posix() for p in root.rglob("*")
             if p.is_file() and p not in before
             and "__pycache__" not in p.parts}
    assert added == {"configs/iwae_trained.json",
                     "workloads/train.tiny_iwae.json"}


@pytest.mark.parametrize("fault", TRAIN_FAULTS["iwae"],
                         ids=[f.__name__ for f in TRAIN_FAULTS["iwae"]])
def test_iwae_program_fault_is_not_correct(iwae_root, fault, monkeypatch):
    _, root, _ = iwae_root
    fault(monkeypatch, "iwae")
    line, _ = run_cell(layout.cell("train.tiny_iwae", root), 2 ** 31 + 3,
                       0.2, False, "cpu")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["control", *calibrate.FAULTS["iwae"]])
def test_iwae_reference_fault_is_not_correct(iwae_root, fault):
    """The control and each of ``calibrate``'s VIMCO faults, in the
    program's place, fail the cell's limits."""
    _, root, _ = iwae_root
    cell = layout.cell("train.tiny_iwae", root)
    cfg, seed, cpu = cell["config_doc"]["config"], 2 ** 31 + 7, \
        torch.device("cpu")
    if fault == "control":
        numbers = calibrate.control_numbers(cell, seed, cpu)
    else:
        w = weights.make(cfg, False, seed, cpu)
        bank = rtrain.synth.digit_bank(cfg["data"]["digit_size"], cpu)
        ref = rtrain.Trainer(cfg, w, bank, seed).follow(3)
        got = calibrate._faulty(cfg, w, bank, seed,
                                calibrate.FAULTS["iwae"][fault])
        numbers = compare.train_numbers(got, ref)
    checks = compare.judge(numbers, cell["limits"])
    assert not compare.passed(checks), checks


#: ``chunks`` under another name: its run, tiny traffic and calibration,
#: but for a tiny cut of its own and a mark on its control's numbers.
_TWIN = """
from air_bench import layout

_CHUNKS = layout.kind("chunks")
TINY = _CHUNKS.TINY


def run(r):
    _CHUNKS.run(r)


def tiny_config(cfg):
    cfg["train"]["scan_steps"] = 3
    return cfg


def control_numbers(cell, seed, dev):
    return dict(_CHUNKS.control_numbers(cell, seed, dev), twin_reached=1.0)


def readings(cell, seeds, controls, dev):
    return _CHUNKS.readings(cell, seeds, controls, dev)
"""

_TWIN_RUN = """
import json, torch
from air_bench import calibrate, layout
from air_bench.run import run_cell
from air_bench.tests.conftest import tiny_cell
cell = tiny_cell("twin.canonical_fast")
line, _ = run_cell(cell, 2 ** 31 + 13, 0.2, False, "cpu")
cpu = torch.device("cpu")
print(json.dumps({
    "root": str(layout.ROOT), "line": line,
    "scan_steps": cell["config_doc"]["config"]["train"]["scan_steps"],
    "control": calibrate.control_numbers(cell, 2 ** 31 + 17, cpu),
    "summary": calibrate.summarize(
        calibrate.hook(cell, "readings")(cell, [2 ** 31 + 19], 0, cpu))}))
"""


def test_a_kind_is_files(tmp_path):
    """A third traffic kind added as files alone runs ``correct`` on the
    CPU, and calibration and the tiny cut reach its own functions."""
    root, before = _copy(tmp_path)
    (root / "traffic" / "twin.py").write_text(_TWIN)
    (root / "traffic" / "twin_train.json").write_text(json.dumps(
        dict(layout.load("traffic", "train"), kind="twin")))
    (root / "workloads" / "twin.canonical_fast.json").write_text(json.dumps(
        dict(layout.load("workloads", "train.canonical_fast"),
             traffic="twin_train")))
    out = subprocess.run([sys.executable, "-c", _TWIN_RUN], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{tmp_path}:{layout.ROOT.parent}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["root"] == str(root)
    line = got["line"]
    assert line["correct"], line["checks"]
    assert got["scan_steps"] == 3 and line["attempted"] % 3 == 0
    assert got["control"]["twin_reached"] == 1.0
    assert got["summary"] and all(set(v) == {"program_max"}
                                  for v in got["summary"].values())
    for p, data in before.items():
        assert p.read_bytes() == data, p
    added = {p.relative_to(root).as_posix() for p in root.rglob("*")
             if p.is_file() and p not in before
             and "__pycache__" not in p.parts}
    assert added == {"traffic/twin.py", "traffic/twin_train.json",
                     "workloads/twin.canonical_fast.json"}


@pytest.mark.parametrize("kind", [p.stem for p in sorted(
    (layout.ROOT / "traffic").glob("*.py"))])
def test_every_kind_owns_its_calibration(kind):
    mod = layout.kind(kind)
    for name in ("run", "control_numbers", "readings"):
        assert callable(getattr(mod, name, None)), (kind, name)


def test_a_kind_without_calibration_is_named(monkeypatch):
    monkeypatch.setattr(layout, "kind", lambda name, root=layout.ROOT:
                        types.SimpleNamespace(run=lambda r: None))
    cell = layout.cell("train.canonical_fast")
    cell["traffic_doc"] = dict(cell["traffic_doc"], kind="bare")
    with pytest.raises(AttributeError, match="'bare'.* control_numbers"):
        calibrate.control_numbers(cell, 1, torch.device("cpu"))
    with pytest.raises(AttributeError, match="'bare'.* readings"):
        calibrate.hook(cell, "readings")


@pytest.mark.parametrize("controls", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_readings_through_the_kind(name, controls):
    """``calibrate``'s readings of a tiny cell through its kind, and their
    summary: with no controls it has each number's program reading alone;
    with one, the control's and each fault's smallest beside it."""
    cell = tiny_cell(name)
    out = calibrate.hook(cell, "readings")(cell, [2 ** 31 + 23], controls,
                                           torch.device("cpu"))
    assert len(out["program"]) == 1 and len(out["control"]) == controls
    assert all(len(v) == controls for k, v in out.items() if k != "program")
    assert compare.passed(compare.judge(out["program"][0], cell["limits"]))
    summary = calibrate.summarize(out)
    assert set(summary) == set(out["program"][0])
    kept = {"program_max"} | {f"{k}_min" for k in out if k != "program"} \
        if controls else {"program_max"}
    for number, entry in summary.items():
        assert set(entry) == kept, (number, entry)
        assert entry["program_max"] == out["program"][0][number]
