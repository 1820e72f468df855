"""Train a preset through the port's CLI on the card and read its quality
against the JAX reference's committed runs.

    python3 scripts/torch_quality.py [--config canonical_fast] [--seeds 0]
                                     [--iters STEP]

Each seed runs ``python -m attend_infer_repeat_torch.train --config C
--seed S --iters N`` in a fresh temporary workdir (the checkpoints stay
there and go with it); its stdout, ``metrics.jsonl`` and ``restarts.json``
are copied to ``chiprun_out/quality/`` as ``<config>_seed<S>*``.  Prints,
per seed: the held-out eval at step N (``count_accuracy_mode``, ELBO),
the basin rows, the wall per 500 steps (from the JSONL's ``wall_s``),
every reference seed's eval at the same step, the bars and whether the run
meets them; then one JSON line.

``REFERENCES`` names, per preset, the reference runs (``runs/<glob>``,
each with a ``metrics.jsonl``) and the step its bars are read at (the
default ``--iters``).  The bars follow from those runs at the step
(``bars``): the count accuracy at least the lowest reference seed less
0.005 (for an ablation that collapses, at most the highest plus 0.05),
and the eval ELBO inside the reference seeds' range widened by 10 nats on
each side.  The port draws from torch generators, so its seed S is not the
reference's stream: a run is held to the spread of the reference seeds,
not to one seed.
"""

from __future__ import annotations

import argparse
import dataclasses
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
ACC_MARGIN, COLLAPSE_MARGIN, ELBO_MARGIN = 0.005, 0.05, 10.0


@dataclasses.dataclass(frozen=True)
class Reference:
    runs: str            # glob of run directories under runs/
    step: int            # the step the bars are read at
    collapses: bool = False   # the ablation's count accuracy falls to ~0


REFERENCES = {
    "canonical_fast": Reference("cfv6_seed*", 10_000),
    "canonical_uniform": Reference("uniform_v6_s*", 20_000),
    "canonical_uniform28": Reference("u28v7_seed*", 20_000),
    "iwae_trained": Reference("iwae_trained_r3", 10_000),
    "crowded": Reference("crowded_b1024_seed3*", 50_000),
    "no_nvil": Reference("no_nvil_r2", 10_000, collapses=True),
}


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


def reference_runs(config):
    """``{run name: metrics rows}`` of the preset's reference runs."""
    ref = REFERENCES[config]
    dirs = sorted(p for p in (ROOT / "runs").glob(ref.runs) if p.is_dir())
    return {p.name: rows_of(p / "metrics.jsonl") for p in dirs}


def reference_at(config, step):
    """``{run name: (count_accuracy_mode, elbo)}``: each reference run's
    held-out eval at ``step`` (runs that did not log it are left out)."""
    out = {}
    for name, rows in reference_runs(config).items():
        ev = at(rows, "eval", step)
        if ev is not None:
            out[name] = (ev["count_accuracy_mode"], ev["elbo"])
    return out


def bars(config, step):
    """``(accuracy bar, "min" or "max", (elbo lo, elbo hi))`` at ``step``
    from the reference runs' eval rows there."""
    refs = reference_at(config, step)
    if not refs:
        raise ValueError(f"no reference run of {config} logged step {step}")
    accs = [a for a, _ in refs.values()]
    elbos = [e for _, e in refs.values()]
    if REFERENCES[config].collapses:
        acc = (max(accs) + COLLAPSE_MARGIN, "max")
    else:
        acc = (min(accs) - ACC_MARGIN, "min")
    return acc[0], acc[1], (min(elbos) - ELBO_MARGIN,
                            max(elbos) + ELBO_MARGIN)


def meets(config, step, accuracy, elbo):
    """``(accuracy met, elbo met)`` of an eval row's two numbers."""
    acc_bar, kind, (lo, hi) = bars(config, step)
    acc_ok = accuracy >= acc_bar if kind == "min" else accuracy <= acc_bar
    return acc_ok, lo <= elbo <= hi


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical_fast",
                   choices=sorted(REFERENCES))
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--iters", type=int, default=None,
                   help="train to this step (default: the preset's "
                        "reference step)")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "quality"))
    args = p.parse_args()
    iters = args.iters or REFERENCES[args.config].step
    acc_bar, kind, elbo_bar = bars(args.config, iters)
    import torch

    if not torch.cuda.is_available():
        print("torch_quality: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(f"{args.config} to step {iters}: count_accuracy_mode "
          f"{'>=' if kind == 'min' else '<='} {acc_bar:.4f}, eval elbo in "
          f"[{elbo_bar[0]:.1f}, {elbo_bar[1]:.1f}]", flush=True)
    os.makedirs(args.out, exist_ok=True)
    reference = {k: {"count_accuracy_mode": a, "elbo": e}
                 for k, (a, e) in reference_at(args.config, iters).items()}
    summary = []
    for seed in args.seeds:
        stem = f"{args.config}_seed{seed}"
        with tempfile.TemporaryDirectory(prefix="air_quality_") as tmp:
            log = Path(args.out, f"{stem}.log")
            t = time.perf_counter()
            with open(log, "w") as f:
                rc = subprocess.run(
                    [sys.executable, "-m", "attend_infer_repeat_torch.train",
                     "--config", args.config, "--seed", str(seed),
                     "--iters", str(iters), "--workdir", tmp,
                     "--no-tensorboard"], cwd=ROOT, stdout=f,
                    stderr=subprocess.STDOUT).returncode
            wall = time.perf_counter() - t
            for name in ("metrics.jsonl", "restarts.json"):
                if os.path.exists(os.path.join(tmp, name)):
                    shutil.copy(os.path.join(tmp, name),
                                Path(args.out, f"{stem}_{name}"))
            path = os.path.join(tmp, "metrics.jsonl")
            rows = rows_of(path) if os.path.exists(path) else []
        ev = at(rows, "eval", iters) or {}
        acc, elbo = ev.get("count_accuracy_mode"), ev.get("elbo")
        acc_ok, elbo_ok = (False, False) if acc is None else meets(
            args.config, iters, acc, elbo)
        row = {
            "config": args.config, "seed": seed, "step": iters, "rc": rc,
            "wall_s": wall, "count_accuracy_mode": acc, "elbo": elbo,
            "accuracy_bar": [kind, acc_bar], "elbo_bar": list(elbo_bar),
            "accuracy_met": acc_ok, "elbo_met": elbo_ok,
            "basin": [{k: r[k] for k in ("step", "accuracy", "tv",
                                          "attempt")}
                      for r in rows if r["split"] == "basin"],
            "wall_per_500_s": wall_per_500(rows),
            "reference": reference,
        }
        summary.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"device": smi, "runs": summary}), flush=True)
    return 0 if all(r["rc"] == 0 for r in summary) else 1


if __name__ == "__main__":
    sys.exit(main())
