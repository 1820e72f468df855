"""The share of the traced sub-window of SPACE train steps in which no
kernel, copy or memset runs on the card.  Cells of the ``scenes``
traffic kind only."""

UNIT = "%"


def read(r):
    if r.kind != "scenes":
        return None
    return 100.0 * (1.0 - r.summary["busy_s"] / r.summary["wall_s"])
