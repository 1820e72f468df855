"""Model FLOP utilisation of the SPACE train steps of the window outside
the traced sub-window (the profiler slows what it traces): their model
FLOPs' least time at the float32 peak (``yardstick.space_work``), over
their wall.  Cells of the ``scenes`` traffic kind only."""

from air_bench.yardstick import space_work

UNIT = "%"


def read(r):
    if r.kind != "scenes" or r.peaks is None:
        return None
    if not r.untraced.get("wall_s"):
        return None
    least = r.untraced["images"] * space_work.least_seconds(r.cfg, r.peaks)
    return 100.0 * least / r.untraced["wall_s"]
