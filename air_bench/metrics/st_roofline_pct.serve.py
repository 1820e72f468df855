"""The spatial transformer's share of its roofline in bulk requests: the
least time of the requests' ST work (``yardstick.st_bytes.request``, at
the card's HBM rate) over the device time of the kernels whose names
start with ``st_gather``.  Bulk serving cells only."""

from air_bench.yardstick import st_bytes

UNIT = "%"


def read(r):
    if r.kind != "closed_loop" or r.peaks is None \
            or not r.summary["st_kernel_s"]:
        return None
    n = r.traced["requests"]
    work = n * st_bytes.request(r.cfg, r.traced["images"] // n)
    return 100.0 * work / r.peaks["hbm_bytes_s"] / r.summary["st_kernel_s"]
