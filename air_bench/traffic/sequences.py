"""Training Sequential AIR (SQAIR) on moving-digit sequences in K-step
chunks: the job ``train()`` would run between log points.

Set-up builds the program's SQAIR train state (``create_train_state``
with the configuration's ``sequence`` section) with the benchmark's
weights (``reference.sqair.make_weights``), hands the digit bank to
``make_scan_train_step(config, model, bank, K)`` with K the
configuration's ``scan_steps`` (each step synthesizes its sequences on
the device), and calls it once: the first call captures the step and runs
steps 1..K, of which the reference (``reference.sqair.Trainer``) follows
1..3.  The window then calls the same object chunk after chunk, one chunk
queued ahead, and ends when the chunk in flight at ``--seconds`` has
completed.  A program without ``SequenceConfig`` stops at once
(``ImportError``).

``train_img_s``: frames (sequences × T) of every step run in the window
over the window.  ``r.traced`` and ``r.untraced`` count sequences as
``images``.  Traced (``--trace 1``): the ``trace_chunks`` chunks that
follow the window's last.

Compared (``numbers``): each of steps 1..3's readings by relative gap,
``loss`` and ``iwae_bound`` relative to the reference's mean |log weight|
(a bound near zero would make its own relative gap meaningless).
Calibration: ``control_numbers`` (the reference one precision lower) and
``readings`` (the program, the control and ``FAULTS``).
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from air_bench import program
from air_bench.reference import compare, synth
from air_bench.reference import sqair as rsqair
from air_bench.reference.precision import Precision
from air_bench.run import clocks
from air_bench.yardstick import trace

FOLLOWED = 3
#: What keeps a run short at the tiny widths of the CPU tests.
TINY = {"trace_chunks": 1}
#: The readings compared relative to the mean |log weight|.
ON_LOG_W = ("loss", "iwae_bound")


def tiny_config(cfg: dict) -> dict:
    """The sequence section cut for the CPU tests: 3 frames, 2 slots,
    widths of 8."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["max_steps"] = 2
    cfg["sequence"].update(frames=3, temporal_hidden=8, relation_hidden=8,
                           prior_hidden=8, proposal_hidden=[8])
    return cfg


def sequence_config(cfg: dict):
    """The program's ``SequenceConfig`` of the configuration."""
    from attend_infer_repeat_torch.configs import SequenceConfig

    return SequenceConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg["sequence"].items()})


def train_state(cfg: dict, seed: int, dev):
    """A fresh SQAIR train state of the program with the benchmark's
    weights of ``seed``."""
    state = program.air().create_train_state(
        program.config(cfg), seed=seed, device=dev,
        sequence=sequence_config(cfg))
    program.load_weights(state.model, rsqair.make_weights(cfg, seed, dev))
    return state


def numbers(program_rows: dict, reference: dict) -> dict:
    """``<reading>_gap.<s>`` of steps 1..3: ``|program - reference|`` over
    the reference's mean |log weight| for ``ON_LOG_W``, over its own
    magnitude for the rest."""
    out = {}
    for key, ref in reference.items():
        if key not in program_rows or key == "log_w_abs":
            continue
        for s, (p, r) in enumerate(zip(program_rows[key], ref)):
            scale = reference["log_w_abs"][s] if key in ON_LOG_W else abs(r)
            out[f"{key}_gap.{s + 1}"] = abs(p - r) / scale
    return out


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def run(r) -> None:
    sequence_config(r.cfg)              # a program without SQAIR stops here
    cfg, dev, p = r.cfg, r.device, r.traffic
    k = cfg["train"]["scan_steps"]
    batch = cfg["train"]["batch_size"]
    frames = cfg["sequence"]["frames"]
    if r.trace:
        trace.warm_up_profiler(dev)
    state = train_state(cfg, r.seed, dev)
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    r.mark("train state")
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, k)
    state, rows = scan(state)
    first = {key: rows[key][:FOLLOWED].tolist() for key in rsqair.READINGS}
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
    r.e2e["train_img_s"] = (steps * batch * frames / window, "img/s")
    r.attempted = steps
    r.failed = int((~torch.isfinite(torch.cat(losses))).sum())
    r.traced = {"chunks": sub.count, "steps": sub.count * k,
                "images": sub.count * k * batch} if r.trace else {}
    r.window_done(steps * batch, window)
    gaps = np.diff(done) if len(done) > 1 else np.zeros(1)
    r.say(f"chunks: issue s median {np.median(issue)} max {max(issue)}; "
          f"between completions s median {np.median(gaps)} min "
          f"{gaps.min()} max {gaps.max()}; {clocks()}")
    r.say(f"window: {i} chunks of {k} steps at {batch} sequences of "
          f"{frames} frames in {window} s; launches a step: st_gather "
          f"{(launches1[0] - launches0[0]) / steps}, st_gather_bwd "
          f"{(launches1[1] - launches0[1]) / steps}; step graph pool "
          f"{pools} bytes; set-up {r.setup_s} s")
    r.read_memory_peak()
    del scan, state, rows, losses
    program.free(dev)

    t = time.perf_counter()
    followed = rsqair.Trainer(cfg, rsqair.make_weights(cfg, r.seed, dev),
                              bank, r.seed).follow(FOLLOWED)
    r.checks = compare.judge(numbers(first, followed), r.limits)
    r.say(f"reference: {FOLLOWED} steps in {time.perf_counter() - t} s; "
          f"program {first}, reference {followed}")


# --- calibration (air_bench.calibrate) ------------------------------------
def _reference(cfg, seed, dev, bank, prec=None):
    return rsqair.Trainer(cfg, rsqair.make_weights(cfg, seed, dev), bank,
                          seed, prec).follow(FOLLOWED)


def _switch(value):
    return lambda clean: value


def _faults() -> dict:
    """Each planted fault of the reference in the program's place, as
    ``calibrate.FAULTS`` gives them (``groups``, ``patch``): the state
    unchanged, the loss over half the batch, the loss altered by 1 %, the
    relation LSTM's state zeroed (``r``) and discovery's canvas starting
    at zero instead of the propagated render (``d``)."""
    from air_bench import calibrate

    return {
        "unchanged": dict(groups=()),
        "half_batch": dict(patch=(rsqair, "vimco_loss",
                                  calibrate._half_vimco)),
        "altered_loss": dict(patch=(rsqair, "vimco_loss",
                                    calibrate._altered)),
        "no_relation": dict(patch=(rsqair.SQAIR, "relation",
                                   _switch(False))),
        "disc_from_zero": dict(patch=(rsqair.SQAIR, "disc_from_render",
                                      _switch(False))),
    }


def fault_numbers(cell, seed, dev, name, ref=None) -> dict:
    """The numbers of fault ``name`` (``_faults``) against the reference
    (``ref``, its readings, where already taken)."""
    cfg = cell["config_doc"]["config"]
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    fault = _faults()[name]
    trainer = rsqair.Trainer(cfg, rsqair.make_weights(cfg, seed, dev), bank,
                             seed)
    trainer.groups = fault.get("groups", trainer.groups)
    if "patch" in fault:
        owner, attr, wrap = fault["patch"]
        clean = getattr(owner, attr)
        setattr(owner, attr, wrap(clean))
        try:
            got = trainer.follow(FOLLOWED)
        finally:
            setattr(owner, attr, clean)
    else:
        got = trainer.follow(FOLLOWED)
    return numbers(got, ref or _reference(cfg, seed, dev, bank))


def control_numbers(cell, seed, dev, ref=None) -> dict:
    """The reference's first three steps one precision lower against its
    own (``ref``, where already taken)."""
    cfg = cell["config_doc"]["config"]
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    return numbers(_reference(cfg, seed, dev, bank, Precision(lower=True)),
                   ref or _reference(cfg, seed, dev, bank))


def readings(cell, seeds, controls, dev) -> dict:
    """The program's first three steps over ``seeds`` (one K-step entry,
    fed each seed's weights and a fresh optimizer state in place), then
    the control's and each fault's over the first ``controls`` seeds."""
    from air_bench.calibrate import _say

    cfg = cell["config_doc"]["config"]
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    state = train_state(cfg, seeds[0], dev)
    scan = program.air().make_scan_train_step(
        program.config(cfg), state.model, bank, cfg["train"]["scan_steps"])
    out = {"program": [], "control": []}
    refs = {}
    for seed in seeds:
        program.load_weights(state.model,
                             rsqair.make_weights(cfg, seed, dev))
        for g in state.opt_state.values():
            for t in (*g.nu, *g.trace):
                t.zero_()
            g.count = 0
        state.step, state.base_seed = 0, seed
        state, rows = scan(state)
        first = {k: rows[k][:FOLLOWED].tolist() for k in rsqair.READINGS}
        refs[seed] = _reference(cfg, seed, dev, bank)
        out["program"].append(_say("program", seed,
                                   numbers(first, refs[seed])))
    del scan, state
    program.free(dev)
    for seed in seeds[:controls]:
        out["control"].append(_say("control", seed, control_numbers(
            cell, seed, dev, refs[seed])))
        for name in _faults():
            out.setdefault(name, []).append(_say(name, seed, fault_numbers(
                cell, seed, dev, name, refs[seed])))
    return out
