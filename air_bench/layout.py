"""Where the benchmark finds a cell's parts, by name.

``workloads/<cell>.json``   the cell: its ``config``, ``traffic``,
                            ``chips``, ``why`` and the ``limits`` of the
                            numbers that decide ``correct``
``configs/<config>.json``   the configuration as it is run (``config``),
                            with its ``source``, ``reduced`` and ``assumed``
``traffic/<traffic>.json``  the traffic mix's parameters; ``kind`` names
                            the generator that reads them
``traffic/<kind>.py``       that generator: sets up, drives the window and
                            checks the answers (``run(r)``); reads the
                            kind's calibration (``control_numbers``,
                            ``readings``: ``air_bench.calibrate``); cuts a
                            cell for the CPU tests (``TINY`` traffic keys,
                            optional ``tiny_config(cfg)``)
``metrics/<metric>.py``     a per-layer metric's reader (``read(r)``)

A later cell, configuration, traffic mix or metric is a file added beside
these; no file here names them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    path = Path(root) / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{name!r}: no file {path}")
    return path


def load(folder: str, name: str, root: Path = ROOT) -> dict:
    with open(_path(root, folder, name, ".json")) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic documents."""
    doc = load("workloads", name, root)
    return dict(doc, name=name, config_doc=load("configs", doc["config"], root),
                traffic_doc=load("traffic", doc["traffic"], root))


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, root: Path = ROOT):
    """The traffic generator module of kind ``name``."""
    return _module(_path(root, "traffic", name, ".py"),
                   f"air_bench.traffic.{name}")


def metric_readers(root: Path = ROOT) -> dict:
    """Every per-layer metric's reader, by metric name."""
    return {p.name[:-3]: _module(p, f"air_bench.metrics.{p.name[:-3]}")
            for p in sorted((Path(root) / "metrics").glob("*.py"))
            if p.name != "__init__.py"}
