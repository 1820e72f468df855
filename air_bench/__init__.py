"""The benchmark of ``attend_infer_repeat_torch``, the PyTorch/CUDA port
of AIR, on an H100.

``python -m air_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``run``).  Cells, configurations, traffic
mixes and per-layer metrics are files found by name (``layout``); the
arithmetic the numbers rest on is in ``yardstick`` and the plain
reference that decides ``correct`` in ``reference``.  ``calibrate``
reads the program's, the control's and the planted faults' compared
numbers over many seeds.
"""
