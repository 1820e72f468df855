"""Model FLOP utilisation of the train steps of the window outside the
traced sub-window (the profiler slows what it traces):
their model FLOPs' least time, each product at its stated dtype's peak
(``yardstick.flops``), over their wall.  Train cells only."""

from air_bench.yardstick import flops

UNIT = "%"


def read(r):
    if r.kind != "chunks" or r.peaks is None:
        return None
    if not r.untraced.get("wall_s"):
        return None
    least = r.untraced["images"] * flops.least_seconds(
        r.cfg, True, r.cfg["train"]["use_baseline"], r.peaks)
    return 100.0 * least / r.untraced["wall_s"]
