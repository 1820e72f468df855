"""The card's idle share while the host replays a step: hole time
between device work inside the program's ``graph.launch`` spans, over the
traced sub-window's wall.  Train cells whose program has the span only."""

from air_bench.yardstick import spans

UNIT = "%"


def read(r):
    if r.kind != "chunks":
        return None
    s = spans.of(r)
    if "graph.launch" not in s.ranges:
        return None
    return 100.0 * s.idle_in_us("graph.launch") * 1e-6 / r.sub.wall_s
