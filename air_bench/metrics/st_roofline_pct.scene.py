"""The spatial transformer's share of its roofline in SPACE train steps:
the least time of the steps' ST work (``yardstick.space_work.train_step``:
the indexed gathers, the pastes and the synthesis, at the card's HBM
rate) over the device time of the kernels whose names start with
``st_gather``.  Cells of the ``scenes`` traffic kind only."""

from air_bench.yardstick import space_work

UNIT = "%"


def read(r):
    if r.kind != "scenes" or r.peaks is None \
            or not r.summary["st_kernel_s"]:
        return None
    work = sum(space_work.train_step(r.cfg).values()) * r.traced["steps"]
    return 100.0 * work / r.peaks["hbm_bytes_s"] / r.summary["st_kernel_s"]
