"""Model FLOP utilisation of the bulk requests of the window outside the
traced sub-window (the profiler slows what it traces):
the forward's model FLOPs (the served model with its NVIL baseline, as
the train state holds it), each product at its stated dtype's peak, over
the sub-window's wall.  Bulk serving cells only."""

from air_bench.yardstick import flops

UNIT = "%"


def read(r):
    if r.kind != "closed_loop" or r.peaks is None:
        return None
    if not r.untraced.get("wall_s"):
        return None
    least = r.untraced["images"] * flops.least_seconds(
        r.cfg, False, r.cfg["train"]["use_baseline"], r.peaks)
    return 100.0 * least / r.untraced["wall_s"]
