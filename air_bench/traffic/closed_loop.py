"""Bulk scoring: one client, one request in flight, fixed-size requests.

Each request is ``batch`` canvases taken in turn from a pool of
``pool_batches * batch`` in pinned host memory, made in set-up from the
seed.  Set-up makes the served model and the pool and sends one request
(it captures the request's graph).  The window sends requests back to
back; each one's answers are copied to the host before the next is sent.
It ends when the request in flight at ``--seconds`` has its answers.

``infer_img_s``: the images of every request answered in the window over
the window.  A request fails when an answer is not finite.  Checked:
``sample_requests`` requests drawn from the seed (a reservoir over the
window).  Traced (``--trace 1``): the ``trace_requests`` requests that
follow the window's last.
"""

from __future__ import annotations

import time


from air_bench import program, serve
from air_bench.run import clocks
from air_bench.yardstick import rng, trace


def run(r) -> None:
    p, dev = r.traffic, r.device
    batch, n_pool = p["batch"], p["pool_batches"]
    if r.trace:
        trace.warm_up_profiler(dev)
    srv = serve.Server(r)
    r.mark("served model")
    pool = serve.canvases(r.cfg, n_pool * batch, r.seed, dev).reshape(
        n_pool, batch, *r.cfg["data"]["canvas_size"])
    r.mark("canvas pool")
    host = serve.HostOut(r.cfg, batch, dev)
    host.fetch(srv.infer(pool[0], srv.gen), batch)
    pools = program.graph_pools(srv.infer)
    r.setup_done()

    k, pick = p["sample_requests"], rng(r.seed, "sample")
    kept = []
    sub = r.sub = trace.SubWindow(r.trace, None, p["trace_requests"], dev)
    launches0 = program.launches()
    t0 = time.perf_counter()
    i = failed = 0
    while True:
        slot = i if i < k else int(pick.integers(0, i + 1))
        st = srv.gen.get_state() if slot < k else None
        sub.before(i)
        with sub.span("request", i):
            out = srv.infer(pool[i % n_pool], srv.gen)
        with sub.span("to_host", i):
            answers = host.fetch(out, batch)
        sub.after(i)
        failed += not serve.finite(answers)
        if st is not None:
            item = (i % n_pool, st, {key: v.clone()
                                     for key, v in answers.items()})
            if slot == len(kept):
                kept.append(item)
            else:
                kept[slot] = item
        i += 1
        if time.perf_counter() - t0 >= r.seconds:
            sub.arm(i)
            if sub.done:
                break
    window = time.perf_counter() - t0
    launches1 = program.launches()

    r.e2e["infer_img_s"] = (i * batch / window, "img/s")
    r.attempted, r.failed = i, failed
    r.traced = {"requests": sub.count, "images": sub.count * batch} \
        if r.trace else {}
    r.window_done(i * batch, window)
    r.say(f"window: {i} requests of {batch} in {window} s; st_gather "
          f"launches a request {(launches1[0] - launches0[0]) / i}; graph "
          f"pools {pools} bytes; set-up {r.setup_s} s; {clocks()}")
    r.read_memory_peak()
    srv.close()
    program.free(dev)
    t = time.perf_counter()
    r.checks = serve.check(r, srv.weights,
                           [(pool[j], st, a) for j, st, a in kept])
    r.say(f"reference: {len(kept)} requests in {time.perf_counter() - t} s")
