"""Read a cell's compared numbers over many seeds: the program's, the
control's and the planted faults'.  The limits in ``workloads/<cell>.json``
are set from them (``PERF.md`` gives the readings).

    python -m air_bench.calibrate --workload <cell> --seeds 12 --controls 3
        [--first-seed N]

The cell's traffic kind owns its calibration: ``traffic/<kind>.py`` gives
``control_numbers(cell, seed, dev)``, the compared numbers with the
reference one precision lower in the program's place, and
``readings(cell, seeds, controls, dev)``, ``{"program": [...], "control":
[...], <fault>: [...]}`` with one dict of numbers a seed.  This module
asks the kind for both (``hook``); ``chunks`` points at ``train_control``
and ``train_readings`` below, ``closed_loop`` at ``serve_control`` and
``serve_readings``.

One process per cell, one set-up: the cell's entry is built once and fed
each seed's weights in place (a graph holds its tensors' addresses), so
each seed costs one call of the entry and the reference.

- program: train cells (``chunks``) call the K-step entry from a fresh
  state of the seed and compare its first three steps with the reference;
  serving cells (``closed_loop``) send the cell's checked requests (as
  many as a run checks, the longest among them) through the infer entry
  and compare the answers.
- control: the reference computed one precision below the configuration
  (``Precision(lower=True)``: fp8 for bfloat16, TF32 for float32) in the
  program's place.
- faults (train cells), in the reference put in the program's place, by
  the configuration's objective (``FAULTS``).  Both: a step that leaves
  its state unchanged; the loss over half of the batch; a step's loss
  altered by 1 %.  ``elbo``: a step that moves the baseline group alone
  and leaves the model group unchanged.  ``iwae`` (VIMCO, no baseline
  group): each particle's advantage without its leave-one-out baseline,
  the bound itself; the mean of the particles' log weights in place of
  the bound, ``logsumexp - log k``.

Prints one JSON line a reading, then per number the largest program
reading and the smallest reading of the control and of each fault that
was read (none with ``--controls 0``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from air_bench import layout, program, serve
from air_bench.reference import air as rair
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


def _half_nvil(clean):
    return lambda out, beta: clean(_half(out), beta)


def _half_vimco(clean):
    def half(log_w, log_q):
        cut = log_w.shape[1] // 2
        return clean(log_w[:, :cut], log_q[:, :cut])
    return half


def _altered(clean):
    def altered(*args):
        value, terms = clean(*args)
        return 1.01 * value, terms
    return altered


def _no_loo(clean):
    return torch.zeros_like


def _elbo_mean(clean):
    return lambda log_w: log_w.mean(0)


#: By objective: each fault's ``groups`` that the update moves (every
#: group, unless given) and the reference function it wraps, ``patch =
#: (module, name, wrap)``: ``wrap(clean)`` takes the function's place for
#: the fault's steps.
FAULTS = {
    "elbo": {
        "unchanged": dict(groups=()),
        "model_unchanged": dict(groups=("baseline",)),
        "half_batch": dict(patch=(rtrain, "nvil_loss", _half_nvil)),
        "altered_loss": dict(patch=(rtrain, "nvil_loss", _altered)),
    },
    "iwae": {
        "unchanged": dict(groups=()),
        "half_batch": dict(patch=(rtrain, "vimco_loss", _half_vimco)),
        "altered_loss": dict(patch=(rtrain, "vimco_loss", _altered)),
        "no_loo": dict(patch=(rair, "loo_bounds", _no_loo)),
        "elbo_mean": dict(patch=(rair, "iwae_bound", _elbo_mean)),
    },
}


def _faulty(cfg, w, bank, seed, fault):
    trainer = rtrain.Trainer(cfg, w, bank, seed)
    trainer.groups = fault.get("groups", trainer.groups)
    if "patch" not in fault:
        return trainer.follow(3)
    module, name, wrap = fault["patch"]
    clean = getattr(module, name)
    setattr(module, name, wrap(clean))
    try:
        return trainer.follow(3)
    finally:
        setattr(module, name, clean)


def _requests(cell, seed, dev) -> list:
    """The canvases of the requests a run of the serving cell checks."""
    cfg, p = cell["config_doc"]["config"], cell["traffic_doc"]
    pool = serve.canvases(cfg, p["batch"] * p["sample_requests"], seed, dev)
    return list(pool.reshape(p["sample_requests"], p["batch"],
                             *cfg["data"]["canvas_size"]))


def hook(cell: dict, name: str):
    """The calibration function ``name`` (``control_numbers`` or
    ``readings``) of the cell's traffic kind."""
    kind = cell["traffic_doc"]["kind"]
    fn = getattr(layout.kind(kind), name, None)
    if fn is None:
        raise AttributeError(f"traffic kind {kind!r} (traffic/{kind}.py) "
                             f"has no {name}(): calibration needs "
                             f"control_numbers() and readings()")
    return fn


def control_numbers(cell, seed, dev) -> dict:
    """The cell's numbers with the reference one precision lower in the
    program's place, as the cell's traffic kind reads them."""
    return hook(cell, "control_numbers")(cell, seed, dev)


def train_control(cell, seed, dev) -> dict:
    """``control_numbers`` of a train cell: the reference's first three
    steps one precision lower against the reference's."""
    cfg = cell["config_doc"]["config"]
    w = weights.make(cfg, cfg["train"]["use_baseline"], seed, dev)
    bank = rtrain.synth.digit_bank(cfg["data"]["digit_size"], dev)
    ref = rtrain.Trainer(cfg, w, bank, seed).follow(3)
    low = rtrain.Trainer(cfg, w, bank, seed, Precision(lower=True)).follow(3)
    return compare.train_numbers(low, ref)


def serve_control(cell, seed, dev) -> dict:
    """``control_numbers`` of a serving cell: the reference's answers to
    the checked requests one precision lower against the reference's."""
    cfg = cell["config_doc"]["config"]
    w = weights.make(cfg, cfg["train"]["use_baseline"], seed, dev)
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
        first = {k: rows[k][:3].tolist() for k in rtrain.readings(cfg)}
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
        for name, fault in FAULTS[cfg["train"]["objective"]].items():
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


def summarize(out: dict) -> dict:
    """Per number: the largest program reading, and the smallest reading
    of the control and of each fault that has readings."""
    return {number: {
        "program_max": max(x[number] for x in out["program"]),
        **{f"{k}_min": min(x[number] for x in v)
           for k, v in out.items() if k != "program" and v}}
        for number in out["program"][0]}


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
    out = hook(cell, "readings")(cell, seeds, args.controls,
                                 torch.device("cuda"))
    print(json.dumps({"workload": args.workload, "seconds":
                      time.perf_counter() - t, "summary": summarize(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
