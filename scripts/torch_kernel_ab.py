"""Time the port's kernels on two trees of the repo in one session.

Runs ``chip_smoke.py`` of a parent checkout and of this tree in turns
(parent, change, change, parent), reads each run's ``kernels`` line, and
prints every timed row of both kernels side by side: the two runs of each
tree, the ratio of their means, and the sums over one train step's
launches (phase 5b).  Run it on one card, from the repo root::

    mkdir -p _checkout/parent
    git archive <parent commit> | tar -x -C _checkout/parent
    python3 scripts/torch_kernel_ab.py --parent _checkout/parent

Each run's full output goes to ``chiprun_out/kernel_ab/`` under the
working directory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_smoke(tree: Path, log: Path, timeout: float) -> dict:
    """``chip_smoke.py`` in ``tree``; {(kernel, case, n): row} of its
    timed rows.  Raises if the run fails."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"chip_smoke.py in {tree} exited "
                           f"{proc.returncode}; see {log}")
    line = next(s for s in proc.stdout.splitlines()
                if s.startswith('{"kernels"'))
    return {(k["name"], r["case"], r["n"]): r
            for k in json.loads(line)["kernels"] for r in k["shapes"]}


def us_text(values) -> str:
    return ", ".join(f"{x:.2f}" for x in values) or "-"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked checkout of the parent commit")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds allowed for each chip_smoke.py run")
    args = ap.parse_args()
    out = Path.cwd() / "chiprun_out" / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    trees = {"parent": args.parent.resolve(), "change": ROOT}
    runs = {"parent": [], "change": []}
    for i, side in enumerate(("parent", "change", "change", "parent")):
        runs[side].append(run_smoke(trees[side], out / f"{i}_{side}.log",
                                    args.timeout))
        print(f"run {i}: {side} done", flush=True)

    def mean_us(side, key):
        vals = [r[key]["ms"] * 1e3 for r in runs[side] if key in r]
        return vals, (sum(vals) / len(vals) if vals else None)

    rows = []
    print(f"{'kernel':14} {'case':58} {'N':>6} {'parent us':>17} "
          f"{'change us':>17} {'ratio':>6}")
    for key in runs["change"][0]:
        pv, pm = mean_us("parent", key)
        cv, cm = mean_us("change", key)
        ratio = cm / pm if pm else None
        rows.append({"kernel": key[0], "case": key[1], "n": key[2],
                     "parent_us": pv, "change_us": cv, "ratio": ratio})
        print(f"{key[0]:14} {key[1][:58]:58} {key[2]:>6} "
              f"{us_text(pv):>17} {us_text(cv):>17} "
              f"{'' if ratio is None else f'{ratio:.3f}':>6}")
    sums = {}
    for kernel in ("st_gather", "st_gather_bwd"):
        step = [r for r in rows
                if r["kernel"] == kernel and r["case"].startswith("step ")]
        for side in ("parent", "change"):
            per_run = [sum(r[f"{side}_us"][i] for r in step)
                       for i in range(2)]
            sums[f"{kernel} step sum {side} us"] = per_run
    for k, v in sums.items():
        print(f"{k}: {', '.join(f'{x:.2f}' for x in v)}")
    print(json.dumps({"device": smi, "rows": rows, "step_sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
