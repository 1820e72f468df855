"""The host path of a request: the mean time of the program's
``serve.infer`` spans less the ``graph.launch`` spans they hold (the
noise draw, the graph cache's lookup, input fill and output copy).  Bulk
serving cells whose program has the span only."""

from air_bench.yardstick import spans

UNIT = "us/request"


def read(r):
    if r.kind != "closed_loop":
        return None
    own = spans.of(r).self_us("serve.infer", "graph.launch")
    return sum(own) / len(own) if own else None
