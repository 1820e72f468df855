"""The training loop: the train step, with log, eval, figure and save at
intervals.

Step for step the JAX package's ``train/loop.py``: restore-or-init, the
K-step train loop, held-out and held-in evaluation at log points, the
best checkpoint, the IWAE bound, early-basin detect-and-restart with
keep-best, the two-phase ``max_scale`` cap, figures, periodic and final
saves, and a save on SIGTERM/SIGINT.

RNG: the JAX loop folds keys; this one seeds generators from
``numpy.random.SeedSequence`` over the same integers
(``ops.math.seeded_generator``).  Eval batch ``i`` is drawn from
``(seed+1, i)`` (held-in: ``seed+2``), its noise at step ``s`` from
``(seed+1, s, i)``; the basin statistic's noise from
``(seed+1, 0xBA51+i)``; the IWAE batch from ``(seed+1, 0x1A3)`` and its
noise from ``(seed+1, s+1)``; the figure batch from
``(seed+1, 0xF16, s)`` and its noise from ``(seed+1, s)``.  So every
evaluation is a function of ``(seed, step)`` and survives a resume.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import signal
import threading
from typing import Optional

import numpy as np
import torch

from attend_infer_repeat_torch import resolve_device
from attend_infer_repeat_torch.configs import Config, get_config
from attend_infer_repeat_torch.data.digits import load_digit_bank
from attend_infer_repeat_torch.data.loader import (
    InMemoryDataset,
    auto_split,
    load_data,
)
from attend_infer_repeat_torch.data.synth import make_synth_fn
from attend_infer_repeat_torch.eval.figures import make_fig
from attend_infer_repeat_torch.eval.metrics import (
    MetricsLogger,
    evaluate,
    host_scalars,
)
from attend_infer_repeat_torch.ops.math import seeded_generator
from attend_infer_repeat_torch.train.checkpoint import (
    BestCheckpointTracker,
    CheckpointManager,
)
from attend_infer_repeat_torch.train.state import (
    create_train_state,
    param_count,
)
from attend_infer_repeat_torch.train.step import (
    make_eval_step,
    make_scan_train_step,
    make_train_step,
)


def train(config: Config | str, workdir: str = "runs/default",
          n_iters: Optional[int] = None, resume: bool = True,
          use_tensorboard: bool = True, save_checkpoints: bool = True,
          data_path: Optional[str] = None,
          eval_data_path: Optional[str] = None,
          resident_data: bool = True, device=None):
    """Train AIR per ``config``; returns the final ``TrainState``.

    If ``workdir`` holds a checkpoint and ``resume``, training continues
    from it (the anneal position included, through the restored step).

    With ``data_path`` (a reference-format ``{'imgs', 'nums'}`` pickle)
    the dataset is by default moved to the device once and each step
    draws its minibatch there; ``resident_data=False`` streams batches
    from the host instead, from an iterator seeded once with ``seed +
    step`` at the start (after a restore): a basin restart does not
    re-seed it, as the JAX loop does not, so a restarted or replayed
    attempt sees the stream where the failed attempt left it.  ``eval_data_path`` holds the validation
    pickle; without it the training pickle is split 90/10, so that
    ``eval`` rows are always held-out data.  Without ``data_path``
    canvases are synthesized on the device.

    Runs on CUDA unless ``device="cpu"`` (``resolve_device``).
    """
    if isinstance(config, str):
        config = get_config(config)
    tcfg = config.train
    n_iters = tcfg.n_iters if n_iters is None else n_iters
    dev = resolve_device(device)

    # --- data: on-device synthesis (default) or reference pickles --------
    if data_path is not None:
        blob = load_data(data_path)
        if eval_data_path:
            train_ds = InMemoryDataset(blob["imgs"], blob["nums"])
            ev_blob = load_data(eval_data_path)
            eval_ds = InMemoryDataset(ev_blob["imgs"], ev_blob["nums"])
        else:
            train_ds, eval_ds = auto_split(blob)
            print(f"no --eval-data: auto-split {data_path} 90/10 → "
                  f"{len(train_ds)} train / {len(eval_ds)} held-out eval",
                  flush=True)
        train_bank = None
        # resident: the whole dataset on the device, minibatches drawn
        # there; streamed: the iterator is made after the restore, seeded
        # off the resumed step, and (as in the JAX loop) not re-seeded at
        # a basin restart
        stream_data = not resident_data
        device_data = None if stream_data else (
            torch.from_numpy(train_ds.imgs).to(dev),
            torch.from_numpy(train_ds.nums).to(dev))

        def fixed_batch(ds, batch, i):
            # round-robin: slot i of an eval pass is a distinct slice
            lo = (i % max(len(ds) // batch, 1)) * batch
            return (torch.from_numpy(ds.imgs[lo:lo + batch]).to(dev),
                    torch.from_numpy(ds.nums[lo:lo + batch]).to(dev))

        def eval_synth(gen, batch, i=0):
            return fixed_batch(eval_ds, batch, i)

        def train_eval_synth(gen, batch, i=0):
            return fixed_batch(train_ds, batch, i)
    else:
        stream_data = False
        device_data = None
        train_bank, _ = load_digit_bank(
            config.data.source, config.data.digit_size, split="train")
        eval_bank, _ = load_digit_bank(
            config.data.source, config.data.digit_size, split="eval")
        _ev_fn = make_synth_fn(config.data, eval_bank, device=dev)
        # held-in eval batches: the same distribution from the TRAIN bank
        _trev_fn = make_synth_fn(config.data, train_bank, device=dev)

        def eval_synth(gen, batch, i=0):
            return _ev_fn(batch, gen)

        def train_eval_synth(gen, batch, i=0):
            return _trev_fn(batch, gen)

    # --- early-basin restart bookkeeping (TrainConfig.basin_*) -----------
    # ``attempt`` counts detect-and-restart reinitializations; the sidecar
    # makes a preempted attempt resume as itself.
    restart_path = os.path.join(workdir, "restarts.json")
    attempt = 0
    basin_best = {"accuracy": -1.0, "attempt": 0}
    sidecar_seed = None
    if not resume and os.path.exists(restart_path):
        os.remove(restart_path)
    if resume and os.path.exists(restart_path):
        with open(restart_path) as f:
            sidecar = json.load(f)
        attempt = int(sidecar.get("attempt", 0))
        basin_best = sidecar.get("best", basin_best)
        # a replay attempt runs the best attempt's seed
        sidecar_seed = sidecar.get("seed")

    def attempt_seed(a: int) -> int:
        # a prime stride keeps folded seeds far from seed+1 / seed+2
        return tcfg.seed if a == 0 else tcfg.seed + 7919 * a

    # --- model + state ----------------------------------------------------
    state = create_train_state(
        config, seed=attempt_seed(attempt) if sidecar_seed is None
        else sidecar_seed, device=dev)
    print(f"config: {config.name}  model={config.model}  "
          f"train={config.train}  prior={config.prior}  "
          f"data={config.data}", flush=True)
    print("param counts:", param_count(state.model), flush=True)

    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"),
                             fresh=not resume) \
        if save_checkpoints else None
    best = BestCheckpointTracker(os.path.join(workdir, "ckpt_best"),
                                 fresh=not resume) \
        if (save_checkpoints and tcfg.best_metric) else None
    if not resume:
        # a fresh run's metrics and figures must not mix with a stale run's
        for p in glob.glob(os.path.join(workdir, "fig_*.png")):
            os.remove(p)
        if os.path.exists(os.path.join(workdir, "metrics.jsonl")):
            os.remove(os.path.join(workdir, "metrics.jsonl"))
        if os.path.isdir(os.path.join(workdir, "tb")):
            shutil.rmtree(os.path.join(workdir, "tb"))
    if ckpt is not None and resume:
        if ckpt.restore(state) is not None:
            print(f"resumed from step {state.step}", flush=True)

    train_iter = train_ds.batches(
        tcfg.batch_size, seed=tcfg.seed + state.step) \
        if stream_data else None

    # K steps per host dispatch on the on-device data paths
    k_scan = max(1, tcfg.scan_steps) if train_iter is None else 1
    # Two-phase max_scale cap: before ``cap_from`` the loop trains a
    # capless twin of the model (``with_config``: the same Parameter
    # objects under another config), from it the capped model.
    cap_from = config.model.max_scale_from_step \
        if config.model.max_scale is not None else 0
    if k_scan > 1:
        for nm, iv in (("log_every", tcfg.log_every),
                       ("fig_every", tcfg.fig_every),
                       ("save_every", tcfg.save_every)):
            if iv % k_scan:
                raise ValueError(
                    f"{nm}={iv} must be a multiple of scan_steps={k_scan}")
        if cap_from % k_scan:
            raise ValueError(
                f"max_scale_from_step={cap_from} must be a multiple of "
                f"scan_steps={k_scan} (a K-step chunk cannot switch "
                f"models mid-flight)")
    if tcfg.basin_detect_step and tcfg.basin_detect_step % tcfg.log_every:
        raise ValueError(
            f"basin_detect_step={tcfg.basin_detect_step} must be a "
            f"multiple of log_every={tcfg.log_every} (the detector reads "
            f"the held-out eval that runs at log points)")

    base_model = state.model

    def build_steps(mcfg):
        pcfg = dataclasses.replace(config, model=mcfg)
        pmodel = base_model if mcfg == base_model.cfg \
            else base_model.with_config(mcfg)
        steps = {
            "mcfg": mcfg,
            "model": pmodel,
            "train": make_train_step(pcfg, pmodel, digit_bank=train_bank,
                                     device_data=device_data),
            "eval": make_eval_step(pcfg, pmodel),
            "scan": None,
            "iwae": None,
        }
        if k_scan > 1:
            steps["scan"] = make_scan_train_step(
                pcfg, pmodel, train_bank, k_scan, device_data=device_data)
        if tcfg.iwae_eval_particles > 0:
            from attend_infer_repeat_torch.eval.iwae import (
                make_iwae_eval_step)

            # the bound evaluates q at its own samples: the floor-free
            # posterior, as make_eval_step evaluates
            steps["iwae"] = make_iwae_eval_step(
                pcfg, pmodel.with_config(
                    dataclasses.replace(mcfg, explore_eps=None)),
                tcfg.iwae_eval_particles)
        return steps

    phase_steps = {}

    def steps_for(step_no):
        """The active phase's steps (built lazily, cached for the phase).

        The phase only moves forward (a restart clears the cache), so the
        steps of the phase left behind, and their CUDA graphs, are
        released."""
        capped = step_no >= cap_from
        if capped not in phase_steps:
            mcfg = config.model if capped else dataclasses.replace(
                config.model, max_scale=None)
            if not capped:
                print(f"two-phase max_scale: cap {config.model.max_scale} "
                      f"OFF until step {cap_from}", flush=True)
            phase_steps.clear()
            phase_steps[capped] = build_steps(mcfg)
        return phase_steps[capped]

    logger = MetricsLogger(workdir, use_tensorboard=use_tensorboard)
    eval_seed, train_eval_seed = tcfg.seed + 1, tcfg.seed + 2

    def eval_batches():
        for i in range(tcfg.eval_batches):
            yield eval_synth(seeded_generator(dev, eval_seed, i),
                             tcfg.batch_size, i)

    def train_eval_batches():
        for i in range(tcfg.eval_batches):
            yield train_eval_synth(seeded_generator(dev, train_eval_seed, i),
                                   tcfg.batch_size, i)

    def count_marginal_tv(steps, cur_state):
        """Label-free basin statistic: total variation between the model's
        predicted-count marginal on held-out batches and the data's
        (Uniform{min..max} on the synthesis path, the eval pickle's
        histogram on the pickle path)."""
        t = config.model.max_steps
        hist = np.zeros(t + 1)
        nums_hist = np.zeros(t + 1)
        for i, (imgs, nums) in enumerate(eval_batches()):
            _, outs = steps["eval"](
                cur_state, imgs, nums,
                seeded_generator(dev, eval_seed, 0xBA51 + i))
            m = np.clip(outs.mode_steps.cpu().numpy().astype(int), 0, t)
            hist += np.bincount(m, minlength=t + 1)[:t + 1]
            nv = np.clip(nums.cpu().numpy().astype(int), 0, t)
            nums_hist += np.bincount(nv, minlength=t + 1)[:t + 1]
        hist /= max(hist.sum(), 1.0)
        if data_path is None:
            lo, hi = config.data.min_digits, min(config.data.max_digits, t)
            target = np.zeros(t + 1)
            target[lo:hi + 1] = 1.0 / (
                config.data.max_digits - config.data.min_digits + 1)
        else:
            target = nums_hist / max(nums_hist.sum(), 1.0)
        return float(0.5 * np.abs(hist - target).sum())

    # --- preemption save: on SIGTERM/SIGINT finish the in-flight step or
    # chunk, save it, then die of the signal.  Installed only on the main
    # thread of a run that saves; restored on every exit path.
    preempt_sig = {"sig": None}
    prev_handlers = {}

    def on_preempt(signum, frame):
        preempt_sig["sig"] = signum
        # one graceful save per signal: a second one kills
        signal.signal(signum, prev_handlers.get(signum, signal.SIG_DFL))

    if ckpt is not None and \
            threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[s] = signal.signal(s, on_preempt)

    def restore_handlers():
        for s, h in prev_handlers.items():
            signal.signal(s, h)

    figs_enabled = True     # flips off once if matplotlib is absent
    it = state.step
    while it < n_iters:
        steps = steps_for(it)
        state.model = steps["model"]
        if train_iter is None:
            # K-step chunks only from K-aligned steps: a resume off the
            # grid single-steps back onto it (cap_from is K-aligned too,
            # so a chunk never crosses the phase boundary)
            if k_scan > 1 and it % k_scan == 0 and n_iters - it >= k_scan:
                state, chunk = steps["scan"](state)
                metrics = {k: v[-1] for k, v in chunk.items()}
                it += k_scan
            else:
                state, metrics = steps["train"](state)
                it += 1
        else:
            state, metrics = steps["train"](state, next(train_iter))
            it += 1

        step_no = it
        # log and figure follow the phase the completed step ran in (at
        # the boundary, step_no == cap_from selects the capped one)
        steps = steps_for(step_no)
        if step_no % tcfg.log_every == 0 or step_no == n_iters:
            logger.log(step_no, host_scalars(metrics), prefix="train")
            ev = evaluate(steps["eval"], state, eval_batches(),
                          (eval_seed, step_no))
            logger.log(step_no, ev, prefix="eval")
            tr_ev = evaluate(steps["eval"], state, train_eval_batches(),
                             (train_eval_seed, step_no))
            logger.log(step_no, tr_ev, prefix="train_eval")
            if best is not None and tcfg.best_metric in ev:
                if best.offer(state, float(ev[tcfg.best_metric])):
                    print(f"[best {step_no}] {tcfg.best_metric}="
                          f"{best.best:.4f} → ckpt_best", flush=True)
            if steps["iwae"] is not None:
                iw_imgs, _ = eval_synth(
                    seeded_generator(dev, eval_seed, 0x1A3), tcfg.batch_size)
                iw = steps["iwae"](state, iw_imgs, seeded_generator(
                    dev, eval_seed, step_no + 1))
                logger.log(step_no, host_scalars(iw), prefix="iwae")
            # --- early-basin detect-and-restart (TrainConfig.basin_*) --
            if tcfg.basin_detect_step and step_no == tcfg.basin_detect_step:
                acc = float(ev.get("count_accuracy_mode", 1.0))
                tv = count_marginal_tv(steps, state)
                logger.log(step_no, {"accuracy": acc, "tv": tv,
                                     "attempt": float(attempt)},
                           prefix="basin")
                if acc > basin_best["accuracy"]:
                    basin_best = {"accuracy": acc, "attempt": attempt}
                restart_now = (acc < tcfg.basin_accuracy_threshold
                               and attempt < tcfg.basin_max_restarts)
                # keep-best-on-exhaustion: the last allowed attempt failed
                # too and a better one was seen, so replay that attempt's
                # seed; attempt passes max_restarts, so the gate cannot
                # fire on the replay
                replay_now = (not restart_now
                              and acc < tcfg.basin_accuracy_threshold
                              and attempt == tcfg.basin_max_restarts
                              and basin_best["attempt"] != attempt
                              and basin_best["accuracy"] > acc)
                if restart_now or replay_now:
                    attempt += 1
                    if replay_now:
                        new_seed = attempt_seed(basin_best["attempt"])
                        print(f"[basin-restart] exhausted "
                              f"{tcfg.basin_max_restarts} restarts (last "
                              f"gate {acc:.4f}); replaying best attempt "
                              f"{basin_best['attempt']} (gate "
                              f"{basin_best['accuracy']:.4f}) with seed "
                              f"{new_seed}", flush=True)
                    else:
                        new_seed = attempt_seed(attempt)
                        print(f"[basin-restart] held-out mode accuracy "
                              f"{acc:.4f} < "
                              f"{tcfg.basin_accuracy_threshold} "
                              f"at step {step_no} (count-marginal TV "
                              f"{tv:.4f}); reinit "
                              f"{attempt}/{tcfg.basin_max_restarts} with "
                              f"seed {new_seed}", flush=True)
                    with open(restart_path, "w") as f:
                        json.dump({"attempt": attempt, "seed": new_seed,
                                   "trigger_step": step_no,
                                   "trigger_accuracy": acc,
                                   "trigger_tv": tv,
                                   "best": basin_best,
                                   "replay": replay_now}, f)
                    # the host-streamed iterator goes on where it was,
                    # as in the JAX loop: it is not re-seeded
                    state = create_train_state(config, seed=new_seed,
                                               device=dev)
                    base_model = state.model
                    phase_steps.clear()       # and the old steps' graphs
                    if ckpt is not None:
                        ckpt = CheckpointManager(
                            os.path.join(workdir, "ckpt"), fresh=True)
                    if best is not None:
                        best = BestCheckpointTracker(
                            os.path.join(workdir, "ckpt_best"), fresh=True)
                    for p in glob.glob(os.path.join(workdir, "fig_*.png")):
                        os.remove(p)     # stale figures feed the GIF tool
                    it = 0
                    continue
        if figs_enabled and (step_no % tcfg.fig_every == 0
                             or step_no == n_iters):
            imgs, nums = eval_synth(
                seeded_generator(dev, eval_seed, 0xF16, step_no),
                tcfg.batch_size)
            _, outputs = steps["eval"](
                state, imgs, nums, seeded_generator(dev, eval_seed, step_no))
            try:
                make_fig(imgs, outputs,
                         os.path.join(workdir, f"fig_{step_no:07d}.png"),
                         true_nums=nums, max_scale=steps["mcfg"].max_scale)
            except ImportError as e:
                figs_enabled = False
                print(f"figures disabled ({e}); install matplotlib for "
                      f"reconstruction/attention-box figures", flush=True)
        if ckpt is not None and (step_no % tcfg.save_every == 0
                                 or step_no == n_iters):
            ckpt.save(state, force=(step_no == n_iters))
        if preempt_sig["sig"] is not None:
            sig = preempt_sig["sig"]
            if ckpt is not None and ckpt.latest_step() != step_no:
                ckpt.save(state, force=True)
            print(f"[preempt] signal {sig}: saved step {step_no}; "
                  f"exiting", flush=True)
            logger.close()
            restore_handlers()
            # die of the signal, under its default disposition, so the
            # exit status says so
            os.kill(os.getpid(), sig)
            return state   # unreachable for SIGTERM; SIGINT raises

    restore_handlers()
    logger.close()
    state.model = base_model
    return state
