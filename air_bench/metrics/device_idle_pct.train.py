"""The share of the traced sub-window in which no kernel, copy or memset
runs on the card.  Cells of the ``chunks`` traffic kind only."""

UNIT = "%"


def read(r):
    if r.kind != "chunks":
        return None
    return 100.0 * (1.0 - r.summary["busy_s"] / r.summary["wall_s"])
