"""The card's idle share while the host is on a request's path: hole
time between device work inside the program's ``serve.infer`` spans, over
the traced sub-window's wall.  Bulk serving cells whose program has the
span only."""

from air_bench.yardstick import spans

UNIT = "%"


def read(r):
    if r.kind != "closed_loop":
        return None
    s = spans.of(r)
    if "serve.infer" not in s.ranges:
        return None
    return 100.0 * s.idle_in_us("serve.infer") * 1e-6 / r.sub.wall_s
