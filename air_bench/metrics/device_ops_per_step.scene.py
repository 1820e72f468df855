"""Kernels a SPACE train step runs: the kernels in the traced
sub-window's trace over its steps (copies and memsets not counted).
Cells of the ``scenes`` traffic kind only."""

UNIT = "ops/step"


def read(r):
    if r.kind != "scenes" or not r.summary["n_kernels"]:
        return None
    return r.summary["n_kernels"] / r.traced["steps"]
