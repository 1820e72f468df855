"""Training in K-step chunks: the job ``train()`` runs between log points.

Set-up builds the program's train state with the benchmark's weights,
hands the benchmark's digit bank to ``make_scan_train_step(config, model,
bank, K)`` with K the configuration's ``scan_steps`` (canvases are
synthesized on the device inside each step), and calls it once: the
first call captures the step and runs steps 1..K, of which the reference
follows 1..3.  The window then calls the same object chunk after chunk,
one chunk queued ahead as ``train()`` leaves it, and ends when the chunk
in flight at ``--seconds`` has completed.

``train_img_s``: images of every step run in the window over the window.
Traced (``--trace 1``): the ``trace_chunks`` chunks that follow the
window's last.  Each run prints the host's time to issue a chunk and the
time between chunk completions (median, min, max).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from air_bench import program
from air_bench.reference import compare, synth
from air_bench.reference.train import READINGS, Trainer
from air_bench.run import clocks
from air_bench.yardstick import trace, weights

FOLLOWED = 3


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def run(r) -> None:
    cfg, dev, p = r.cfg, r.device, r.traffic
    k = cfg["train"]["scan_steps"]
    batch = cfg["train"]["batch_size"]
    use_baseline = cfg["train"]["use_baseline"]
    if r.trace:
        trace.warm_up_profiler(dev)
    w = weights.make(cfg, use_baseline, r.seed, dev)
    r.mark("weights")
    state = program.train_state(cfg, w, r.seed, dev)
    del w
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    r.mark("train state")
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, k)
    state, rows = scan(state)
    first = {key: rows[key][:FOLLOWED].tolist() for key in READINGS}
    pools = program.graph_pools(scan)
    r.setup_done()

    sub = r.sub = trace.SubWindow(r.trace, None, p["trace_chunks"], dev)
    launches0 = program.launches()
    losses, prev, issue, done = [], None, [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        sub.before(i)
        t = time.perf_counter()
        with sub.span("chunk", i):
            state, rows = scan(state)
        issue.append(time.perf_counter() - t)
        losses.append(rows["loss"])
        ev = _event(dev)
        sub.after(i)
        i += 1
        if prev is not None:
            with sub.span("wait", i - 1):
                prev.synchronize()
            done.append(time.perf_counter())
        prev = ev
        if time.perf_counter() - t0 >= r.seconds:
            sub.arm(i)
            if sub.done:
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    launches1 = program.launches()

    steps = i * k
    r.e2e["train_img_s"] = (steps * batch / window, "img/s")
    r.attempted = steps
    r.failed = int((~torch.isfinite(torch.cat(losses))).sum())
    r.traced = {"chunks": sub.count, "steps": sub.count * k,
                "images": sub.count * k * batch} if r.trace else {}
    r.window_done(steps * batch, window)
    gaps = np.diff(done) if len(done) > 1 else np.zeros(1)
    r.say(f"chunks: issue s median {np.median(issue)} max {max(issue)}; "
          f"between completions s median {np.median(gaps)} min "
          f"{gaps.min()} max {gaps.max()}; {clocks()}")
    r.say(f"window: {i} chunks of {k} steps at batch {batch} in {window} s; "
          f"launches a step: st_gather "
          f"{(launches1[0] - launches0[0]) / steps}, st_gather_bwd "
          f"{(launches1[1] - launches0[1]) / steps}; step graph pool "
          f"{pools} bytes; set-up {r.setup_s} s")
    r.read_memory_peak()
    del scan, state, rows, losses
    program.free(dev)

    t = time.perf_counter()
    followed = Trainer(cfg, weights.make(cfg, use_baseline, r.seed, dev),
                       bank, r.seed).follow(FOLLOWED)
    r.checks = compare.judge(compare.train_numbers(first, followed),
                             r.limits)
    r.say(f"reference: {FOLLOWED} steps in {time.perf_counter() - t} s; "
          f"program {first}, reference {followed}")
