"""The control comes out not ``correct``: the reference, one precision
below the configuration (fp8 for bfloat16, TF32 for float32), put in the
program's place, at each cell's own size on the card.  The benchmark's
runs do not run it; ``air_bench.calibrate`` reads it over several seeds.

    python -m pytest -p no:cacheprovider -m cuda air_bench/tests/test_control.py
"""

from __future__ import annotations

import pytest

from air_bench import calibrate, layout
from air_bench.reference import compare
from air_bench.tests.conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = layout.cell(name)
    numbers = calibrate.control_numbers(cell, 2 ** 32 + 17, cuda)
    checks = compare.judge(numbers, cell["limits"])
    assert not compare.passed(checks), checks
