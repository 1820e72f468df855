"""A cell, a configuration and a per-layer metric added as new files are
found by the harness, with no file that is there edited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from air_bench import layout
from air_bench.tests.conftest import tiny_config

_RUN = """
import json
from air_bench import layout
from air_bench.run import run_cell
line, _ = run_cell(layout.cell("train.tiny_fast"), 5, 0.2, True, "cpu")
print(json.dumps(line))
"""


def test_new_files_are_found(tmp_path):
    root = tmp_path / "air_bench"
    shutil.copytree(layout.ROOT, root,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
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

    env_path = str(tmp_path) + ":" + str(layout.ROOT.parent)
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["steps_traced.train"]["value"] == 4
    for p, data in before.items():
        assert p.read_bytes() == data, p
