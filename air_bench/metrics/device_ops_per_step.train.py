"""Kernels a train step runs: the kernels in the traced sub-window's
trace over its steps (copies and memsets not counted).  Train cells
only."""

UNIT = "ops/step"


def read(r):
    if r.kind != "chunks":
        return None
    return r.summary["n_kernels"] / r.traced["steps"]
