"""Read a cell's compared numbers over many seeds: the program's, the
control's and the planted faults'.  The limits in ``workloads/<cell>.json``
are set from them (``PERF.md`` gives the readings).

    python -m air_bench.calibrate --workload <cell> --seeds 12 --controls 3
        [--first-seed N]

One process per cell, one set-up: the cell's entry is built once and fed
each seed's weights in place (a graph holds its tensors' addresses), so
each seed costs one call of the entry and the reference.

- program: train cells call the K-step entry from a fresh state of the
  seed and compare its first three steps with the reference; serving
  cells send the cell's checked requests (as many as a run checks, the
  longest among them) through the infer entry and compare the answers.
- control: the reference computed one precision below the configuration
  (``Precision(lower=True)``: fp8 for bfloat16, TF32 for float32) in the
  program's place.
- faults (train cells), in the reference put in the program's place: a
  step that leaves its state unchanged; one that moves the baseline
  group alone and leaves the model group unchanged; the loss over half
  of the batch; a step's loss altered by 1 %.

Prints one JSON line a reading, then per number the largest program
reading and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from air_bench import layout, program, serve
from air_bench.reference import compare
from air_bench.reference import train as rtrain
from air_bench.reference.air import sample_noise
from air_bench.reference.precision import Precision
from air_bench.yardstick import derived_seed, weights


def _say(kind, seed, numbers):
    print(json.dumps({"reading": kind, "seed": seed, **numbers}), flush=True)
    return numbers


def _half(out):
    cut = out["elbo"].shape[0] // 2
    return {k: (v[:cut] if torch.is_tensor(v) else
                {a: b[:cut] for a, b in v.items()} if isinstance(v, dict)
                else v) for k, v in out.items()}


def _altered(loss, out, beta):
    value, terms = loss(out, beta)
    return 1.01 * value, terms


FAULTS = {
    "unchanged": dict(groups=(), loss=None),
    "model_unchanged": dict(groups=("baseline",), loss=None),
    "half_batch": dict(groups=rtrain.Trainer.groups,
                       loss=lambda loss, out, beta: loss(_half(out), beta)),
    "altered_loss": dict(groups=rtrain.Trainer.groups, loss=_altered),
}


def _faulty(cfg, w, bank, seed, fault):
    trainer = rtrain.Trainer(cfg, w, bank, seed)
    trainer.groups = fault["groups"]
    if fault["loss"] is None:
        return trainer.follow(3)
    clean = rtrain.nvil_loss
    rtrain.nvil_loss = lambda out, beta: fault["loss"](clean, out, beta)
    try:
        return trainer.follow(3)
    finally:
        rtrain.nvil_loss = clean


def _requests(cell, seed, dev) -> list:
    """The canvases of the requests a run of the serving cell checks."""
    cfg, p = cell["config_doc"]["config"], cell["traffic_doc"]
    pool = serve.canvases(cfg, p["batch"] * p["sample_requests"], seed, dev)
    return list(pool.reshape(p["sample_requests"], p["batch"],
                             *cfg["data"]["canvas_size"]))


def control_numbers(cell, seed, dev) -> dict:
    """The cell's numbers with the reference one precision lower in the
    program's place."""
    cfg = cell["config_doc"]["config"]
    w = weights.make(cfg, cfg["train"]["use_baseline"], seed, dev)
    if cell["traffic_doc"]["kind"] == "chunks":
        bank = rtrain.synth.digit_bank(cfg["data"]["digit_size"], dev)
        ref = rtrain.Trainer(cfg, w, bank, seed).follow(3)
        low = rtrain.Trainer(cfg, w, bank, seed,
                             Precision(lower=True)).follow(3)
        return compare.train_numbers(low, ref)
    g = torch.Generator(dev).manual_seed(derived_seed(seed, "noise"))
    kept = []
    for c in _requests(cell, seed, dev):
        kept.append((c, g.get_state()))
        sample_noise(cfg["model"], c.shape[0], g, dev)
    return compare.serve_numbers(
        serve.reference_answers(cfg, w, kept, dev, Precision(lower=True)),
        serve.reference_answers(cfg, w, kept, dev))


def train_readings(cell, seeds, controls, dev):
    cfg = cell["config_doc"]["config"]
    use_baseline = cfg["train"]["use_baseline"]
    bank = rtrain.synth.digit_bank(cfg["data"]["digit_size"], dev)
    state = program.train_state(
        cfg, weights.make(cfg, use_baseline, seeds[0], dev), seeds[0], dev)
    scan = program.air().make_scan_train_step(
        program.config(cfg), state.model, bank, cfg["train"]["scan_steps"])
    out = {"program": [], "control": []}
    for seed in seeds:
        w = weights.make(cfg, use_baseline, seed, dev)
        program.load_weights(state.model, w)
        for g in state.opt_state.values():
            for t in (*g.nu, *g.trace):
                t.zero_()
            g.count = 0
        state.step, state.base_seed = 0, seed
        state, rows = scan(state)
        first = {k: rows[k][:3].tolist() for k in rtrain.READINGS}
        ref = rtrain.Trainer(cfg, w, bank, seed).follow(3)
        out["program"].append(_say("program", seed,
                                   compare.train_numbers(first, ref)))
    del scan, state
    program.free(dev)
    for seed in seeds[:controls]:
        out["control"].append(_say("control", seed,
                                   control_numbers(cell, seed, dev)))
        w = weights.make(cfg, use_baseline, seed, dev)
        ref = rtrain.Trainer(cfg, w, bank, seed).follow(3)
        for name, fault in FAULTS.items():
            got = _faulty(cfg, w, bank, seed, fault)
            out.setdefault(name, []).append(
                _say(name, seed, compare.train_numbers(got, ref)))
    return out


def serve_readings(cell, seeds, controls, dev):
    from air_bench.run import Run

    cfg = cell["config_doc"]["config"]
    srv = serve.Server(Run(cell, seeds[0], 10.0, False, dev, 0.0))
    out = {"program": [], "control": []}
    for i, seed in enumerate(seeds):
        w = weights.make(cfg, cfg["train"]["use_baseline"], seed, dev)
        program.load_weights(srv.state.model, w)
        srv.gen.manual_seed(derived_seed(seed, "noise"))
        requests = _requests(cell, seed, dev)
        host = serve.HostOut(cfg, max(c.shape[0] for c in requests), dev)
        kept = []
        for c in requests:
            st = srv.gen.get_state()
            answers = host.fetch(srv.infer(c, srv.gen), c.shape[0])
            kept.append((c, st, {k: v.clone() for k, v in answers.items()}))
        ref = serve.reference_answers(cfg, w, kept, dev)
        prog = {k: torch.cat([a[k] for *_, a in kept]) for k in serve.KEYS}
        out["program"].append(_say("program", seed,
                                   compare.serve_numbers(prog, ref)))
        if i < controls:
            out["control"].append(_say("control", seed,
                                       control_numbers(cell, seed, dev)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from air_bench.run import BUILD, nvidia_smi
    from attend_infer_repeat_torch.utils import enable_compilation_cache

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enable_compilation_cache(str(BUILD / "kernels"))
    print(f"card: {nvidia_smi()}", flush=True)
    cell = layout.cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    t = time.perf_counter()
    read = train_readings if cell["traffic_doc"]["kind"] == "chunks" \
        else serve_readings
    out = read(cell, seeds, args.controls, torch.device("cuda"))
    summary = {}
    for number in out["program"][0]:
        summary[number] = {
            "program_max": max(x[number] for x in out["program"]),
            **{f"{k}_min": min(x[number] for x in v)
               for k, v in out.items() if k != "program"}}
    print(json.dumps({"workload": args.workload, "seconds":
                      time.perf_counter() - t, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
