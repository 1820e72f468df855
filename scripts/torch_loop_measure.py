"""The training loop's cost on the card, remat's effect, and a short CLI
run of every training preset.

    python3 scripts/torch_loop_measure.py [--presets] [--overhead] [--remat]

(no flag: all three).  Needs CUDA; prints the card's name and power limit
first and one JSON line per part; the full log goes to stdout.

- ``--overhead``: ``canonical_fast`` at batch 1024, ``train()`` to 200
  steps in K-step chunks of 100 with log, eval (the preset's 8+8
  batches), save and figure points every 100.  Each chunk is timed
  inside the run (synchronised before and after), so the rest of the
  wall splits into the set-up (up to the first chunk) and the log
  points (everything after it that is not a chunk), without comparing
  separate runs whose host speed differs.  Three runs after a warm-up.
- ``--remat``: ``canonical_fast`` train steps with remat off, ``save_st``
  and ``full``, in 4 rounds that each run the three in turn (the order
  rotating): the wall of 250 steps after 3 warm-up steps, scaled to 500,
  and the peak device memory of those steps (``max_memory_allocated``
  after ``reset_peak_memory_stats``).
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


def overhead(air, n=200, k=100, runs=3):
    from attend_infer_repeat_torch.train import loop as loop_mod

    fast = air.get_config("canonical_fast")
    cfg = dataclasses.replace(fast, train=dataclasses.replace(
        fast.train, n_iters=n, scan_steps=k, log_every=k, save_every=k,
        fig_every=k))
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
                wall = time.perf_counter() - t0
            if r:
                setup = chunks[0][0] - t0
                steps_s = sum(d for _, d in chunks)
                rows.append({"wall_s": wall, "setup_s": setup,
                             "chunks_s": steps_s,
                             "log_point_s": (wall - setup - steps_s)
                             / (n // k)})
    finally:
        loop_mod.make_scan_train_step = real
    point = statistics.median(r["log_point_s"] for r in rows)
    step_s = statistics.median(r["chunks_s"] for r in rows) / n
    return {"part": "overhead", "steps": n, "k": k,
            "eval_batches": cfg.train.eval_batches, "runs": rows,
            "log_point_s": point, "step_ms": step_s * 1e3,
            "share_at_log_every_500": point / (point + 500 * step_s)}


def remat(air, n=250, rounds=4):
    from attend_infer_repeat_torch.data import load_digit_bank

    fast = air.get_config("canonical_fast")
    bank, _ = load_digit_bank(fast.data.source, fast.data.digit_size)
    policies = {"off": dict(remat=False), "save_st": dict(remat=True),
                "full": dict(remat=True, remat_policy="full")}
    names = list(policies)
    out = {p: {"wall_500_s": [], "peak_bytes": []} for p in policies}
    for r in range(rounds):
        for name in names[r % 3:] + names[:r % 3]:
            cfg = dataclasses.replace(fast, model=dataclasses.replace(
                fast.model, **policies[name]))
            state = air.create_train_state(cfg)
            step = air.make_train_step(cfg, state.model, digit_bank=bank)
            for _ in range(3):
                state, _ = step(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

            def run():
                s = state
                for _ in range(n):
                    s, m = step(s)
                return m
            m, wall = sync_wall(run)
            if not torch.isfinite(m["loss"]).item():
                raise AssertionError(f"remat {name}: loss not finite")
            out[name]["wall_500_s"].append(wall * 500 / n)
            out[name]["peak_bytes"].append(torch.cuda.max_memory_allocated())
            del state, step
            torch.cuda.empty_cache()
    for v in out.values():
        v["median_wall_500_s"] = statistics.median(v["wall_500_s"])
    return {"part": "remat", "steps": n, "batch": fast.train.batch_size,
            "policies": out}


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
    for flag in ("presets", "overhead", "remat"):
        p.add_argument(f"--{flag}", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_measure: CUDA is not available", file=sys.stderr)
        return 1
    import attend_infer_repeat_torch as air

    everything = not (args.presets or args.overhead or args.remat)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    ok = True
    if args.overhead or everything:
        print(json.dumps(dict(overhead(air), device=smi)), flush=True)
    if args.remat or everything:
        print(json.dumps(dict(remat(air), device=smi)), flush=True)
    if args.presets or everything:
        res = presets()
        ok = all(r["rc"] == 0 for r in res["runs"])
        print(json.dumps(dict(res, device=smi)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
