"""Every cell, cut to a tiny width, runs on the CPU and its check holds:
the reference agrees with the program there (both run the plain spatial
transformer), and the traced run reads its per-layer metrics."""

from __future__ import annotations

import pytest

from air_bench.reference import compare
from air_bench.run import run_cell
from air_bench.tests.conftest import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_is_correct(name, trace):
    line, text = run_cell(tiny_cell(name), 2 ** 31 + 11, 0.3, trace, "cpu")
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and len(text) == len(line["checks"])
    for key, check in line["checks"].items():
        assert check["value"] < 1e-5 or key.endswith("mismatch") \
            and check["value"] == 0.0, (key, check)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    if trace:
        assert "setup_s" not in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2


def test_judge_compares_the_numbers_with_limits():
    with pytest.raises(KeyError):
        compare.judge({}, {"loss_gap.1": 1.0})
    checks = compare.judge({"a": 1.0, "b": float("nan"), "c": 9.0},
                           {"a": 2, "b": 1})
    assert set(checks) == {"a", "b"} and not compare.passed(checks)
    assert compare.passed(compare.judge({"a": 1.0, "c": 9.0}, {"a": 2}))
