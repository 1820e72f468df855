"""Split a SQAIR or SPACE train step's device time by phase, on the card.

    python3 scripts/torch_sqair_phases.py [--model sqair|space]
        [--batch N] [--steps 2] [--seed 7]

Builds the benchmark's configuration of the model
(``air_bench/configs/sqair_k5.json`` or ``space_g16.json``, its weights
from ``--seed``; ``--batch`` defaults to the configuration's) and its
one-step entry (``make_train_step``), and runs train steps eagerly
(``utils.debug_mode``): the spans ``air.sqair.*`` and ``air.space.*`` are
host ranges that only the step's Python opens, and a graph replay runs no
Python.  After one untraced step it traces ``--steps`` steps with
``torch.profiler`` and prints, a step: the device time of the kernels
launched inside each of the forward's spans (SQAIR: ``sqair.propagate``,
``sqair.discover``, ``sqair.compact``, and the synthesis,
``data.sequences``; SPACE: ``space.fg``, ``space.render``, ``space.bg``
and ``data.scenes``), the rest (the log weights or likelihood, the loss,
the backward with remat's recomputes, the update), the kernels, the ST
kernels' time, the device's busy share of the traced wall, and the peak
memory of the untraced step.  The eager step is slower than the graphed
one: its host issues each kernel.  Prints the card's name and power limit
first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: By model: the configuration, its traffic kind and the forward's spans.
MODELS = {
    "sqair": ("sqair_k5", "sequences", ("sqair.propagate", "sqair.discover",
                                        "sqair.compact", "data.sequences")),
    "space": ("space_g16", "scenes", ("space.fg", "space.render", "space.bg",
                                      "data.scenes")),
}


def _train_state(model, cfg, seed, dev):
    from air_bench import layout

    kind = layout.kind(MODELS[model][1])
    if model == "sqair":
        return kind.train_state(cfg, seed, dev)
    from air_bench.reference import space as rspace

    return kind.train_state(cfg, rspace.make_weights(cfg, seed, dev), seed,
                            dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="sqair")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the script, no device times")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from air_bench import layout, program
    from air_bench.reference import synth
    from air_bench.yardstick.trace import summarize
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.profiling import PREFIX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    name, _, spans = MODELS[args.model]
    cfg = copy.deepcopy(layout.load("configs", name)["config"])
    if args.batch is not None:
        cfg["train"]["batch_size"] = args.batch
    dev = torch.device(args.device)
    state = _train_state(args.model, cfg, args.seed, dev)
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    step = program.air().make_train_step(program.config(cfg), state.model,
                                         digit_bank=bank)
    with debug_mode(nans=False):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state, _ = step(state)
        _sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(args.steps):
                state, metrics = step(state)
            _sync(dev)
            wall = time.perf_counter() - t
    summary = summarize(prof, wall)
    by_span = dict.fromkeys(spans, 0.0)
    for e in prof.events():
        name = e.name[len(PREFIX):] if e.name.startswith(PREFIX) else None
        if name in by_span:
            by_span[name] += e.device_time_total * 1e-6
    kernel_s = sum(v for v in _kernel_times(prof))
    out = {f"{k}_ms": 1e3 * v / args.steps for k, v in by_span.items()}
    out.update(
        rest_ms=1e3 * (kernel_s - sum(by_span.values())) / args.steps,
        kernels_ms=1e3 * kernel_s / args.steps,
        kernels=summary["n_kernels"] / args.steps,
        st_kernels_ms=1e3 * summary["st_kernel_s"] / args.steps,
        busy_pct=100.0 * summary["busy_s"] / wall,
        wall_ms=1e3 * wall / args.steps, loss=float(metrics["loss"]),
        peak_bytes=peak, batch=cfg["train"]["batch_size"])
    print(json.dumps(out), flush=True)
    return 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_times(prof):
    """Each kernel's device time (s) in the trace (no copies or memsets)."""
    from air_bench.yardstick.trace import _events, is_copy

    return [(e - s) * 1e-6 for n, d, s, e in _events(prof)
            if d and e > s and not is_copy(n)
            and not n.startswith("air_bench.")]


if __name__ == "__main__":
    sys.exit(main())
