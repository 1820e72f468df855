"""Training SPACE on coloured-digit scenes in K-step chunks: the job
``train()`` would run between log points.

The window is ``chunks.run``'s, run on a private copy of ``chunks.py``
whose train state, weights and reference are SPACE's: set-up builds the
program's train state (``create_train_state`` with the configuration's
``space`` section) with the benchmark's weights
(``reference.space.make_weights``), hands the digit bank to
``make_scan_train_step(config, model, bank, K)`` with K the
configuration's ``scan_steps`` (each step synthesizes its scenes on the
device), and calls it once: the first call captures the step and runs
steps 1..K, of which the reference (``reference.space.Trainer``) follows
1..3.  The window then calls the same object chunk after chunk, one chunk
queued ahead, and ends when the chunk in flight at ``--seconds`` has
completed.  A program without ``SpaceConfig`` stops at once
(``ImportError``).

``train_img_s``: scenes of every step run in the window over the window.
Traced (``--trace 1``): the ``trace_chunks`` chunks that follow the
window's last.  Compared: each of steps 1..3's readings
(``reference.space.READINGS``) by relative gap (``compare.train_numbers``).
Calibration: ``control_numbers`` (the reference one precision lower) and
``readings`` (the program, the control and ``faults``).
"""

from __future__ import annotations

import copy
import gc
import types

from air_bench import layout, program
from air_bench.reference import compare, synth
from air_bench.reference import space as rspace
from air_bench.reference.precision import Precision

FOLLOWED = 3
#: What keeps a run short at the tiny widths of the CPU tests.
TINY = {"trace_chunks": 1}


def tiny_config(cfg: dict) -> dict:
    """The scenes cut for the CPU tests: 32 × 32, a 4 × 4 grid, 8 × 8
    glimpses, widths of 8, K = 2."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["img_size"] = [32, 32]
    cfg["data"].update(canvas_size=[32, 32], digit_size=[4, 4],
                       min_digits=2, max_digits=6)
    cfg["space"].update(
        grid=4, glimpse_size=[8, 8], z_what=4, group_channels=4,
        fg_encoder=[[8, 4, 2, 1], [8, 4, 2, 1], [8, 4, 2, 1], [8, 3, 1, 1]],
        lateral=[8], glimpse_encoder=[[8, 3, 1, 1], [8, 4, 2, 1],
                                      [8, 4, 2, 1], [8, 2, 1, 0]],
        glimpse_decoder=[8, 8, 8, 8], glimpse_decoder_out=8, components=2,
        bg_encoder=[8, 8], bg_embed=8, mask_hidden=8, z_mask=4, z_comp=4,
        comp_prior_hidden=8, bg_decoder=[8, 8, 8, 8, 8, 8],
        horizon=[10, 22], wall_split=[8, 24])
    return cfg


def space_config(cfg: dict):
    """The program's ``SpaceConfig`` of the configuration."""
    from attend_infer_repeat_torch.configs import SpaceConfig

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return SpaceConfig(**{k: tup(v) for k, v in cfg["space"].items()})


def train_state(cfg: dict, weights: dict, seed: int, dev):
    """A fresh SPACE train state of the program with ``weights``."""
    state = program.air().create_train_state(
        program.config(cfg), seed=seed, device=dev, space=space_config(cfg))
    program.load_weights(state.model, weights)
    return state


def _weights(cfg, use_baseline, seed, dev):
    return rspace.make_weights(cfg, seed, dev)


def _free(dev) -> None:
    """``program.free`` after the window, which also collects what set-up
    froze (``Run.setup_done``): the step graph's pool, tens of GB here,
    which the reference's steps need."""
    gc.unfreeze()
    program.free(dev)


def run(r) -> None:
    space_config(r.cfg)                  # a program without SPACE stops here
    loop = layout.kind("chunks")         # a private copy of the module
    loop.weights = types.SimpleNamespace(make=_weights)
    loop.program = types.SimpleNamespace(**dict(
        vars(program), train_state=train_state, free=_free))
    loop.step_readings = lambda cfg: rspace.READINGS
    loop.Trainer = rspace.Trainer
    loop.run(r)


# --- calibration (air_bench.calibrate) ------------------------------------
def _switch(value):
    return lambda clean: value


def _half(clean):
    return lambda elbo: clean(elbo[:elbo.shape[0] // 2])


def faults() -> dict:
    """Each planted fault of the reference in the program's place, as
    ``calibrate.FAULTS`` gives them (``groups``, ``patch``): the state
    unchanged (u), the loss over half the batch (h), the loss altered by
    1 % (a), γ without σ(−z_depth) (``depth``) and π_K dropped, so that the
    masks no longer sum to 1 (``stick``)."""
    return {
        "unchanged": dict(groups=()),
        "half_batch": dict(patch=(rspace, "elbo_loss", _half)),
        "altered_loss": dict(patch=(rspace, "elbo_loss",
                                    lambda clean: lambda e: 1.01 * clean(e))),
        "depth": dict(patch=(rspace.Space, "depth", _switch(False))),
        "stick": dict(patch=(rspace.Space, "stick", _switch(False))),
    }


def _reference(cfg, seed, dev, bank, prec=None):
    return rspace.Trainer(cfg, rspace.make_weights(cfg, seed, dev), bank,
                          seed, prec).follow(FOLLOWED)


def fault_numbers(cell, seed, dev, name, ref=None) -> dict:
    """The numbers of fault ``name`` (``faults``) against the reference
    (``ref``, its readings, where already taken)."""
    cfg = cell["config_doc"]["config"]
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    fault = faults()[name]
    trainer = rspace.Trainer(cfg, rspace.make_weights(cfg, seed, dev), bank,
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
    return compare.train_numbers(got, ref or _reference(cfg, seed, dev,
                                                        bank))


def control_numbers(cell, seed, dev, ref=None) -> dict:
    """The reference's first three steps one precision lower against its
    own (``ref``, where already taken)."""
    cfg = cell["config_doc"]["config"]
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    return compare.train_numbers(
        _reference(cfg, seed, dev, bank, Precision(lower=True)),
        ref or _reference(cfg, seed, dev, bank))


def readings(cell, seeds, controls, dev) -> dict:
    """The program's first three steps over ``seeds`` (one K-step entry,
    fed each seed's weights and a fresh optimizer state in place; its
    graph freed before the reference runs), then the control's and each
    fault's over the first ``controls`` seeds."""
    from air_bench.calibrate import _say

    cfg = cell["config_doc"]["config"]
    bank = synth.digit_bank(cfg["data"]["digit_size"], dev)
    state = train_state(cfg, rspace.make_weights(cfg, seeds[0], dev),
                        seeds[0], dev)
    scan = program.air().make_scan_train_step(
        program.config(cfg), state.model, bank, cfg["train"]["scan_steps"])
    out = {"program": [], "control": []}
    firsts, refs = {}, {}
    for seed in seeds:
        program.load_weights(state.model, rspace.make_weights(cfg, seed, dev))
        for g in state.opt_state.values():
            for t in (*g.nu, *g.trace):
                t.zero_()
            g.count = 0
        state.step, state.base_seed = 0, seed
        state, rows = scan(state)
        firsts[seed] = {k: rows[k][:FOLLOWED].tolist()
                        for k in rspace.READINGS}
    del scan, state, rows
    program.free(dev)                    # the step graph's pool, first
    for seed in seeds:
        refs[seed] = _reference(cfg, seed, dev, bank)
        out["program"].append(_say("program", seed, compare.train_numbers(
            firsts[seed], refs[seed])))
    for seed in seeds[:controls]:
        out["control"].append(_say("control", seed, control_numbers(
            cell, seed, dev, refs[seed])))
        for name in faults():
            out.setdefault(name, []).append(_say(name, seed, fault_numbers(
                cell, seed, dev, name, refs[seed])))
    return out
