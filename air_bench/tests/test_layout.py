"""A cell, a configuration and a per-layer metric added as new files are
found by the harness, with no file that is there edited.  A cell of the
VIMCO objective (``iwae``) is two data files: its configuration and its
workload."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from air_bench import calibrate, layout
from air_bench.reference import compare
from air_bench.reference import train as rtrain
from air_bench.run import run_cell
from air_bench.tests.conftest import iwae_trained, tiny_config
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
