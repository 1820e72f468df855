"""Model FLOP utilisation of the SQAIR train steps of the window outside
the traced sub-window (the profiler slows what it traces): their model
FLOPs' least time, each product at its stated dtype's peak
(``yardstick.sqair_work``), over their wall.  Cells of the ``sequences``
traffic kind only."""

from air_bench.yardstick import sqair_work

UNIT = "%"


def read(r):
    if r.kind != "sequences" or r.peaks is None:
        return None
    if not r.untraced.get("wall_s"):
        return None
    least = r.untraced["images"] * sqair_work.least_seconds(r.cfg, r.peaks)
    return 100.0 * least / r.untraced["wall_s"]
