"""Run one cell of the benchmark of ``attend_infer_repeat_torch``.

    python -m air_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program.  The run builds the
cell's configuration, weights and inputs from the seed, warms up every
shape the cell uses (``setup_s``, from the start of this process),
measures for ``--seconds``, then checks what the timed path produced
against the plain reference (``air_bench/reference``) and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
read from a profiled sub-window of the same window), ``device``, with
``--trace 1`` ``breakdown``, and ``checks``, each compared number beside
its limit, which are also the last lines on standard error.  Earlier
lines give the card's name and power limit, the kernels' launch counts,
the graphs' pools and what the traffic generator reports.

Exits nonzero with no result line without a CUDA card (or fewer than the
cell asks for), and when JAX or the JAX package was imported.  The
kernels build into ``air_bench/build/`` of the checkout, once.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
BUILD = HERE / "build"
#: Top-level module names no run may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "attend_infer_repeat_tpu")


class Run:
    """One run of a cell: what its traffic generator reads and fills in."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.name = cell, cell["name"]
        self.cfg = cell["config_doc"]["config"]
        self.traffic = cell["traffic_doc"]
        self.kind = self.traffic["kind"]
        self.limits = cell["limits"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.setup_s = None
        self.e2e = {}            # end-to-end metric -> (value, unit)
        self.attempted = self.failed = 0
        self.checks = {}         # compared number -> {"value", "limit"}
        self.memory_peak = 0
        self.sub = None          # the traced sub-window
        self.traced = {}         # units of work in the traced sub-window
        self.untraced = {}       # images and wall of the window outside it
        self.phases = []         # set-up phases: (label, s since start)
        self.spans = {}          # host spans outside it: name -> seconds
        self.summary = None      # what its trace says
        self.peaks = None

    def mark(self, label: str) -> None:
        """End of a set-up phase."""
        self.phases.append((label, time.perf_counter() - self.t_start))

    def setup_done(self) -> None:
        """End of set-up.  What set-up made moves out of the collector's
        reach, so that a full collection in the window stays short."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start
        self.say("set-up phases (s from the process's start): " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.phases + [("done",
                                                        self.setup_s)]))

    def window_done(self, images: int, wall_s: float) -> None:
        """The images and wall of the window outside the traced
        sub-window and the profiler's own start and stop (the profiler
        slows what it traces)."""
        sub = self.sub
        if self.trace and sub is not None and sub.session_s is not None:
            images -= self.traced["images"]
            wall_s -= sub.session_s
        self.untraced = {"images": images, "wall_s": wall_s}

    def say(self, text: str) -> None:
        print(text, flush=True)

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def clocks() -> str:
    """The card's clocks, power draw and temperature now."""
    try:
        return "card now: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu", "--format=csv,noheader"], capture_output=True,
            text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None) -> tuple:
    """Run ``cell``; returns ``(line, checks_text)``: the result line as a
    dict and the lines of compared numbers."""
    import torch

    from air_bench import layout
    from air_bench.reference.compare import passed
    from air_bench.yardstick import peaks
    from air_bench.yardstick.trace import summarize

    device = torch.device(device)
    r = Run(cell, seed, seconds, trace, device,
            time.perf_counter() if t_start is None else t_start)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    r.peaks = peaks.for_device(name)
    r.mark("imports")
    layout.kind(r.kind).run(r)

    line = {"correct": bool(r.checks) and passed(r.checks) and not r.failed,
            "attempted": r.attempted, "failed": r.failed}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": cell["chips"],
           "memory_peak_bytes": r.memory_peak}
    if trace:
        metrics = {}
        if r.sub is not None and r.sub.prof is not None:
            r.summary = summarize(r.sub.prof, r.sub.wall_s)
            dev["busy_s"] = r.summary["busy_s"]
            dev["window_s"] = r.summary["wall_s"]
        for metric, reader in layout.metric_readers().items():
            value = reader.read(r) if r.summary is not None else None
            if value is not None:
                metrics[metric] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in r.e2e.items()}
        metrics["setup_s"] = {"value": r.setup_s, "unit": "s"}
    line.update(metrics=metrics, device=dev)
    if r.summary is not None:
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in r.summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in r.summary["idle_gaps"]]}
        r.say(f"traced sub-window: {r.traced}, wall {r.summary['wall_s']} s, "
              f"device busy {r.summary['busy_s']} s, "
              f"{r.summary['n_kernels']} kernels, "
              f"{r.summary['n_device_events']} device events")
    line["checks"] = r.checks
    text = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in r.checks.items()]
    return line, text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from air_bench import layout

    cell = layout.cell(args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(BUILD / sub)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {nvidia_smi()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    from attend_infer_repeat_torch.utils import enable_compilation_cache

    enable_compilation_cache(str(BUILD / "kernels"))
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    leaked = forbidden_modules()
    if leaked:
        print(f"imported {', '.join(leaked)}: the benchmark runs the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(checks) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
