"""The host's time to issue a train step: the program's ``train.steps``
spans (a call of K graphed steps: their inputs, re-seeding and replays)
over the traced sub-window's steps.  Train cells whose program has the
span only."""

from air_bench.yardstick import spans

UNIT = "us/step"


def read(r):
    if r.kind != "chunks":
        return None
    s = spans.of(r)
    if "train.steps" not in s.ranges:
        return None
    return s.total_us("train.steps") / r.traced["steps"]
