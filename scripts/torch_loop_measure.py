"""The training loop's cost on the card, remat's effect, and a short CLI
run of every training preset.

    python3 scripts/torch_loop_measure.py [--presets] [--overhead] [--split]
        [--remat]

(no flag: all four).  Needs CUDA; prints the card's name and power limit
first and one JSON line per part; the full log goes to stdout.

- ``--overhead``: ``canonical_fast`` at batch 1024, ``train()`` to 1500
  steps in K-step chunks of 100 (each a replay of the captured step)
  with log, eval (the preset's 8+8 batches), save and figure points at
  the preset's 500.  Each chunk is timed inside the run (synchronised
  before and after), so the rest of the wall splits into the set-up (up
  to the first chunk) and each log point (from the end of the chunk
  that reaches its step to the next chunk), without comparing separate
  runs whose host speed differs.  The first chunk captures the step's
  graph and the first log point the log point's graphs, once a run:
  both are reported apart, and the steady wall per 500 steps is 500
  steps plus one later log point.  Three runs after a warm-up.
- ``--split``: the same run with the IWAE step on (5 particles), each
  part of a log point timed where ``train()`` calls it, synchronised
  before and after: synthesis of the eval batches, the eval forwards,
  the IWAE step, host copies, the best checkpoint, the save, the JSONL
  rows, the figure attempt.  Two runs after a warm-up; seconds in the
  first log point and per later log point.
- ``--remat``: ``canonical_fast`` train steps with remat off, ``save_st``
  and ``full``, in 4 rounds that each run the three in turn (the order
  rotating), eagerly (``make_train_step``) and through the graphed chunk
  (``make_scan_train_step``, K = 50, captured before the timing): the
  wall of 250 steps after warm-up, scaled to 500, and the peak device
  memory of those steps (``max_memory_allocated`` after
  ``reset_peak_memory_stats``; a graph's private pool counts).
- ``--presets``: ``python -m attend_infer_repeat_torch.train --config P
  --iters 3`` for each training preset, at its own widths and batch, in a
  temporary workdir; exit code, wall, and the logged step-3 metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
TRAIN_PRESETS = ("canonical", "canonical_fast", "canonical_uniform",
                 "canonical_uniform28", "crowded", "iwae", "iwae_trained",
                 "no_nvil", "single_digit")


def sync_wall(fn, *args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def overhead(air, n=1500, k=100, every=500, runs=3):
    from attend_infer_repeat_torch.train import loop as loop_mod

    fast = air.get_config("canonical_fast")
    cfg = dataclasses.replace(fast, train=dataclasses.replace(
        fast.train, n_iters=n, scan_steps=k, log_every=every,
        save_every=every, fig_every=every))
    real = loop_mod.make_scan_train_step
    chunks = []

    def timed_scan(*args, **kw):
        scan = real(*args, **kw)

        def run(state):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = scan(state)
            torch.cuda.synchronize()
            chunks.append((t, time.perf_counter() - t))
            return out
        return run

    loop_mod.make_scan_train_step = timed_scan
    rows = []
    try:
        for r in range(runs + 1):                     # run 0 warms up
            chunks.clear()
            with tempfile.TemporaryDirectory(prefix="air_overhead_") as tmp:
                t0 = time.perf_counter()
                air.train(cfg, workdir=tmp, use_tensorboard=False)
                torch.cuda.synchronize()
                end = time.perf_counter()
            if r:
                setup = chunks[0][0] - t0
                steps_s = sum(d for _, d in chunks)
                # a log point: the time from the end of the chunk that
                # reaches its step to the next chunk's start (or the end)
                starts = [t for t, _ in chunks[1:]] + [end]
                points = [s - (t + d)
                          for i, ((t, d), s) in enumerate(zip(chunks, starts))
                          if (i + 1) * k % every == 0]
                rows.append({"wall_s": end - t0, "setup_s": setup,
                             "first_chunk_s": chunks[0][1],
                             "chunks_s": steps_s,
                             "step_ms": sum(d for _, d in chunks[1:])
                             / (n - k) * 1e3,
                             "wall_per_500_s": (end - t0 - setup) * 500 / n,
                             "log_points_s": points})
    finally:
        loop_mod.make_scan_train_step = real
    first = statistics.median(r["log_points_s"][0] for r in rows)
    point = statistics.median(p for r in rows for p in r["log_points_s"][1:])
    step_s = statistics.median(r["step_ms"] for r in rows) / 1e3
    return {"part": "overhead", "steps": n, "k": k, "log_every": every,
            "eval_batches": cfg.train.eval_batches, "runs": rows,
            "first_log_point_s": first, "log_point_s": point,
            "step_ms": step_s * 1e3,
            "wall_per_500_s": statistics.median(r["wall_per_500_s"]
                                                for r in rows),
            "steady_wall_per_500_s": 500 * step_s + point * 500 / every,
            "share_at_log_every_500": point / (point + 500 * step_s)}


def split(air, n=1500, k=100, every=500, runs=2, iwae_particles=5):
    """The log point's parts: ``--overhead``'s run with the IWAE step on
    (``iwae_particles``, as the ``iwae`` presets run it), each part timed
    where ``train()`` calls it, between two ``torch.cuda.synchronize()``,
    and charged to the log point it runs in.  The first log point also
    captures the graphs of the eval forward, the synthesis and the IWAE
    step, once for the run, so it is reported apart from the later ones.
    The synchronisations keep the parts from overlapping, so their sum
    can exceed ``--overhead``'s unsynchronised log point."""
    from attend_infer_repeat_torch.eval import iwae as iwae_mod
    from attend_infer_repeat_torch.eval import metrics as metrics_mod
    from attend_infer_repeat_torch.train import loop as loop_mod

    fast = air.get_config("canonical_fast")
    cfg = dataclasses.replace(fast, train=dataclasses.replace(
        fast.train, n_iters=n, scan_steps=k, log_every=every,
        save_every=every, fig_every=every,
        iwae_eval_particles=iwae_particles))
    points = [{} for _ in range(n // every)]
    done = {"chunks": 0}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                # the log point after the last chunk run so far
                part = points[max(done["chunks"] * k // every - 1, 0)]
                part[name] = part.get(name, 0.0) + time.perf_counter() - t
        return run

    def timed_maker(name, maker):
        return lambda *args, **kw: timed(name, maker(*args, **kw))

    def counted_scan(*args, **kw):
        scan = real_scan(*args, **kw)

        def run(state):
            out = scan(state)
            done["chunks"] += 1
            return out
        return run

    real_scan = loop_mod.make_scan_train_step
    patches = [
        (loop_mod, "make_synth_fn", timed_maker("synthesis",
                                                loop_mod.make_synth_fn)),
        (loop_mod, "make_eval_step", timed_maker("eval forwards",
                                                 loop_mod.make_eval_step)),
        (iwae_mod, "make_iwae_eval_step",
         timed_maker("iwae", iwae_mod.make_iwae_eval_step)),
        (loop_mod, "host_scalars", timed("host copies",
                                         loop_mod.host_scalars)),
        (metrics_mod, "host_scalars", timed("host copies",
                                            metrics_mod.host_scalars)),
        (loop_mod.BestCheckpointTracker, "offer",
         timed("best checkpoint", loop_mod.BestCheckpointTracker.offer)),
        (loop_mod.CheckpointManager, "save",
         timed("save", loop_mod.CheckpointManager.save)),
        (loop_mod.MetricsLogger, "log", timed("log rows",
                                              loop_mod.MetricsLogger.log)),
        (loop_mod, "make_fig", timed("figure", loop_mod.make_fig)),
        (loop_mod, "make_scan_train_step", counted_scan),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    rows = []
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        for r in range(runs + 1):                     # run 0 warms up
            for p in points:
                p.clear()
            done["chunks"] = 0
            with tempfile.TemporaryDirectory(prefix="air_split_") as tmp:
                t0 = time.perf_counter()
                air.train(cfg, workdir=tmp, use_tensorboard=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if r:
                rows.append({"wall_s": wall,
                             "log_points": [dict(p) for p in points]})
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    names = sorted({name for r in rows for p in r["log_points"] for name in p})

    def median_part(name, later):
        vals = [p.get(name, 0.0) for r in rows
                for p in (r["log_points"][1:] if later
                          else r["log_points"][:1])]
        return statistics.median(vals)

    first = {name: median_part(name, False) for name in names}
    later = {name: median_part(name, True) for name in names}
    return {"part": "split", "steps": n, "k": k, "log_every": every,
            "eval_batches": cfg.train.eval_batches,
            "iwae_particles": iwae_particles, "runs": rows,
            "first_log_point_s": first,
            "sum_first_log_point_s": sum(first.values()),
            "per_log_point_s": later,
            "sum_per_log_point_s": sum(later.values())}


def remat(air, n=250, k=50, rounds=4):
    from attend_infer_repeat_torch.data import load_digit_bank

    fast = air.get_config("canonical_fast")
    bank, _ = load_digit_bank(fast.data.source, fast.data.digit_size)
    policies = {"off": dict(remat=False), "save_st": dict(remat=True),
                "full": dict(remat=True, remat_policy="full")}
    names = list(policies)
    out = {f"{p}/{mode}": {"wall_500_s": [], "peak_bytes": []}
           for p in policies for mode in ("eager", "graph")}
    for r in range(rounds):
        for name in names[r % 3:] + names[:r % 3]:
            cfg = dataclasses.replace(fast, model=dataclasses.replace(
                fast.model, **policies[name]))
            for mode in ("eager", "graph"):
                state = air.create_train_state(cfg)
                if mode == "eager":
                    step, per = air.make_train_step(
                        cfg, state.model, digit_bank=bank), 1
                else:
                    step, per = air.make_scan_train_step(
                        cfg, state.model, bank, k), k
                for _ in range(max(3 // per, 1)):  # warm-up; captures
                    state, _ = step(state)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()

                def run():
                    s = state
                    for _ in range(n // per):
                        s, m = step(s)
                    return m
                m, wall = sync_wall(run)
                if not torch.isfinite(m["loss"]).all().item():
                    raise AssertionError(f"remat {name} {mode}: loss not "
                                         f"finite")
                key = f"{name}/{mode}"
                out[key]["wall_500_s"].append(wall * 500 / n)
                out[key]["peak_bytes"].append(
                    torch.cuda.max_memory_allocated())
                del state, step
                torch.cuda.empty_cache()
    for v in out.values():
        v["median_wall_500_s"] = statistics.median(v["wall_500_s"])
    return {"part": "remat", "steps": n, "k": k,
            "batch": fast.train.batch_size, "policies": out}


def presets(iters=3):
    rows = []
    for name in TRAIN_PRESETS:
        with tempfile.TemporaryDirectory(prefix=f"air_{name}_") as tmp:
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "attend_infer_repeat_torch.train",
                 "--config", name, "--iters", str(iters), "--workdir", tmp,
                 "--no-tensorboard"], cwd=ROOT, capture_output=True,
                text=True, timeout=900)
            wall = time.perf_counter() - t
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            path = os.path.join(tmp, "metrics.jsonl")
            logged = [json.loads(line) for line in open(path)] \
                if os.path.exists(path) else []
        last = {r["split"]: r for r in logged if r["step"] == iters}
        rows.append({
            "preset": name, "rc": proc.returncode, "wall_s": wall,
            "splits": sorted(last),
            "train_elbo": last.get("train", {}).get("elbo"),
            "eval_count_accuracy_mode": last.get("eval", {}).get(
                "count_accuracy_mode"),
            "iwae_bound": last.get("iwae", {}).get("iwae_bound"),
        })
        print(json.dumps(rows[-1]), flush=True)
    return {"part": "presets", "iters": iters, "runs": rows}


def main() -> int:
    p = argparse.ArgumentParser()
    for flag in ("presets", "overhead", "split", "remat"):
        p.add_argument(f"--{flag}", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_measure: CUDA is not available", file=sys.stderr)
        return 1
    import attend_infer_repeat_torch as air

    everything = not (args.presets or args.overhead or args.split
                      or args.remat)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    ok = True
    if args.overhead or everything:
        print(json.dumps(dict(overhead(air), device=smi)), flush=True)
    if args.split or everything:
        print(json.dumps(dict(split(air), device=smi)), flush=True)
    if args.remat or everything:
        print(json.dumps(dict(remat(air), device=smi)), flush=True)
    if args.presets or everything:
        res = presets()
        ok = all(r["rc"] == 0 for r in res["runs"])
        print(json.dumps(dict(res, device=smi)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
