"""Train ``canonical_fast`` through the port's CLI on the card and read its
quality against the JAX reference's logs (``runs/cfv6_seed*``).

    python3 scripts/torch_quality.py [--seeds 0 1] [--iters 10000]

Each seed runs ``python -m attend_infer_repeat_torch.train --config
canonical_fast --seed S --iters N`` in a fresh temporary workdir (the
checkpoints stay there and go with it); its stdout and ``metrics.jsonl``
are copied to ``chiprun_out/quality/``.  Prints, per seed: the held-out
eval at the last step (``count_accuracy_mode``, ELBO), the basin rows,
the wall per 500 steps (from the JSONL's ``wall_s``), and the reference's
numbers at the same step; then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def rows_of(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def at(rows, split, step):
    """The last row of ``split`` at ``step`` (a restarted run logs again)."""
    hits = [r for r in rows if r["split"] == split and r["step"] == step]
    return hits[-1] if hits else None


def wall_per_500(rows):
    """Median wall between consecutive train rows 500 steps apart, within
    one attempt (a restart sends the step back to 0)."""
    train = [r for r in rows if r["split"] == "train"]
    gaps = [b["wall_s"] - a["wall_s"] for a, b in zip(train, train[1:])
            if b["step"] - a["step"] == 500]
    return statistics.median(gaps) if gaps else None


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--iters", type=int, default=10_000)
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "quality"))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_quality: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    summary = []
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="air_quality_") as tmp:
            log = Path(args.out, f"seed{seed}.log")
            t = time.perf_counter()
            with open(log, "w") as f:
                rc = subprocess.run(
                    [sys.executable, "-m", "attend_infer_repeat_torch.train",
                     "--config", "canonical_fast", "--seed", str(seed),
                     "--iters", str(args.iters), "--workdir", tmp,
                     "--no-tensorboard"], cwd=ROOT, stdout=f,
                    stderr=subprocess.STDOUT).returncode
            wall = time.perf_counter() - t
            for name in ("metrics.jsonl", "restarts.json"):
                if os.path.exists(os.path.join(tmp, name)):
                    shutil.copy(os.path.join(tmp, name),
                                Path(args.out, f"seed{seed}_{name}"))
            rows = rows_of(os.path.join(tmp, "metrics.jsonl"))
        ev = at(rows, "eval", args.iters) or {}
        ref_path = ROOT / "runs" / f"cfv6_seed{seed}" / "metrics.jsonl"
        ref = at(rows_of(ref_path), "eval", args.iters) \
            if ref_path.exists() else None
        row = {
            "seed": seed, "rc": rc, "wall_s": wall,
            "count_accuracy_mode": ev.get("count_accuracy_mode"),
            "elbo": ev.get("elbo"),
            "basin": [{k: r[k] for k in ("step", "accuracy", "tv",
                                          "attempt")}
                      for r in rows if r["split"] == "basin"],
            "wall_per_500_s": wall_per_500(rows),
            "reference": None if ref is None else {
                "count_accuracy_mode": ref["count_accuracy_mode"],
                "elbo": ref["elbo"]},
        }
        summary.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"device": smi, "runs": summary}), flush=True)
    return 0 if all(r["rc"] == 0 for r in summary) else 1


if __name__ == "__main__":
    sys.exit(main())
