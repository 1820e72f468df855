"""Nothing the benchmark loads is JAX or the JAX package, and its
reference loads nothing of the program: top-level module names, compared
whole, in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from air_bench import layout

ROOT = layout.ROOT.parent

_ALL = """
import importlib, json, pkgutil, sys
import air_bench, air_bench.run
from air_bench import layout
from air_bench.tests.conftest import tiny_cell
for m in pkgutil.walk_packages(air_bench.__path__, "air_bench."):
    importlib.import_module(m.name)
for path in sorted((layout.ROOT / "traffic").glob("*.py")):
    layout.kind(path.stem)
layout.metric_readers()
air_bench.run.run_cell(tiny_cell("train.canonical_fast"), 3, 0.1, True, "cpu")
air_bench.run.run_cell(tiny_cell("serve_bulk.canonical_fast"), 3, 0.1,
                       False, "cpu")
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""

_REFERENCE = """
import importlib, json, pkgutil, sys
import air_bench.reference
for m in pkgutil.walk_packages(air_bench.reference.__path__,
                               "air_bench.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_no_jax_anywhere():
    names = _top_level(_ALL)
    assert "attend_infer_repeat_torch" in names      # the program ran
    assert not names & {"jax", "jaxlib", "flax", "attend_infer_repeat_tpu"}


def test_reference_imports_nothing_of_the_program():
    names = _top_level(_REFERENCE)
    assert "air_bench" in names
    assert not names & {"attend_infer_repeat_torch", "jax", "jaxlib",
                        "flax", "attend_infer_repeat_tpu"}
