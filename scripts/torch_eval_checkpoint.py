"""Evaluate a trained run's checkpoint on held-out digits with the PyTorch
port.

The port's counterpart of ``scripts/eval_checkpoint.py``, the standard
post-run evaluator, with the same flags and output plus ``--device``
(default ``cuda``; with no card it raises unless given ``--device cpu``).
It restores ``<workdir>/ckpt`` (the latest step) or, with ``--best``,
``<workdir>/ckpt_best`` (the step its ``best.json`` names), then prints
``restored step N``, the count confusion matrix over ``--batches``
held-out batches, one JSON line with the sampled and MAP count accuracies,
the ELBO and ``kl_steps`` (4 decimals), and with ``--iwae`` one with the
5-particle IWAE bound (2 decimals) of the floor-free model
(``explore_eps=None``, as the training loop's IWAE).  ``--model-set``,
``--data-set`` and ``--train-seed`` match a trained variant
(``scripts/torch_run_variant.py``).

    python3 scripts/torch_eval_checkpoint.py --config canonical_fast \\
        --workdir runs/cf_seed0 --batches 16 [--iwae] [--best]

Held-out batch ``i`` is synthesized from the digit bank's ``eval`` split
with a generator seeded from ``(seed, i)``; the confusion pass draws batch
``i``'s noise from ``(seed, 9999, i)``, the accuracy pass from ``(seed,
777, i)``; the IWAE batch from ``(seed, 31)`` and its noise from ``(seed,
32)``: the JAX script's ``fold_in`` integers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch import resolve_device  # noqa: E402
from attend_infer_repeat_torch.configs import (  # noqa: E402
    apply_overrides,
    get_config,
)
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    make_synth_fn,
)
from attend_infer_repeat_torch.eval import (  # noqa: E402
    count_confusion,
    evaluate,
    format_confusion,
    make_iwae_eval_step,
)
from attend_infer_repeat_torch.eval.metrics import host_scalars  # noqa: E402
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402
from attend_infer_repeat_torch.train import (  # noqa: E402
    BestCheckpointTracker,
    CheckpointManager,
    create_train_state,
    make_eval_step,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical_fast")
    p.add_argument("--workdir", required=True)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--iwae", action="store_true")
    p.add_argument("--best", action="store_true",
                   help="evaluate <workdir>/ckpt_best (best-eval "
                        "snapshot) instead of the latest checkpoint")
    p.add_argument("--train-seed", type=int, default=None,
                   help="seed override used when the run was trained "
                        "(affects only the state template)")
    p.add_argument("--model-set", action="append", metavar="KEY=VALUE",
                   help="ModelConfig overrides matching the trained "
                        "variant (same syntax as torch_run_variant.py)")
    p.add_argument("--data-set", action="append", metavar="KEY=VALUE")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to evaluate (default cuda; never falls "
                        "back)")
    return p.parse_args(argv)


def restore_state(config, workdir: str, best: bool = False, device=None):
    """The run's latest checkpoint (``best``: its best one) restored into
    a fresh ``TrainState`` of ``config``; ``SystemExit`` if there is
    none."""
    sub = "ckpt_best" if best else "ckpt"
    directory = os.path.join(workdir, sub)
    state = create_train_state(config, device=device)
    restored = None
    if os.path.isdir(directory):
        ckpt = BestCheckpointTracker(directory) if best \
            else CheckpointManager(directory)
        restored = ckpt.restore(state)
    if restored is None:
        raise SystemExit(f"no checkpoint under {workdir}/{sub}")
    return restored


def evaluate_checkpoint(state, batches, eval_step, iwae_step=None,
                        iwae_imgs=None, seed: int = 1234) -> dict:
    """The JAX script's evaluation of ``state``, printed as it prints it.

    ``batches``: ``(imgs, nums)`` pairs, read twice; ``eval_step`` as
    ``make_eval_step`` gives it; ``iwae_step`` (``make_iwae_eval_step``)
    runs on ``iwae_imgs`` when given.  In order: ``count_confusion`` and
    its table, ``evaluate``'s accuracies, ELBO and ``kl_steps``, the IWAE
    bound.  Returns the printed values (``table``, ``eval``, ``iwae``),
    the confusion result, the unrounded metrics (``raw``) and each part's
    wall (``seconds``).
    """
    batches = list(batches)
    dev = state.model.device
    seconds = {}
    t = time.perf_counter()
    res = count_confusion(eval_step, state, batches, (seed, 9999))
    seconds["confusion"] = time.perf_counter() - t
    table = format_confusion(res)
    print(table, flush=True)

    # sampled-count accuracy too (the reference's num_step_accuracy)
    t = time.perf_counter()
    ev = evaluate(eval_step, state, batches, (seed, 777))
    seconds["evaluate"] = time.perf_counter() - t
    shown = {k: round(float(v), 4) for k, v in ev.items()
             if "accuracy" in k or k in ("elbo", "kl_steps")}
    print(json.dumps(shown), flush=True)

    iw = iw_shown = None
    if iwae_step is not None:
        t = time.perf_counter()
        iw = host_scalars(iwae_step(state, iwae_imgs,
                                    seeded_generator(dev, seed, 32)))
        seconds["iwae"] = time.perf_counter() - t
        iw_shown = {k: round(float(v), 2) for k, v in iw.items()}
        print(json.dumps(iw_shown), flush=True)
    return {"confusion": res, "table": table, "eval": shown,
            "iwae": iw_shown, "raw": {"eval": ev, "iwae": iw},
            "seconds": seconds}


def main(argv=None) -> dict:
    """Run the evaluator; returns ``evaluate_checkpoint``'s dict with the
    ``restored_step``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    cfg = dataclasses.replace(cfg,
                              model=apply_overrides(cfg.model, args.model_set),
                              data=apply_overrides(cfg.data, args.data_set))
    if args.train_seed is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, seed=args.train_seed))
    state = restore_state(cfg, args.workdir, args.best, dev)
    print(f"restored step {state.step}", flush=True)

    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size,
                              split="eval")
    synth = make_synth_fn(cfg.data, bank, device=dev)
    batches = [synth(args.batch_size, seeded_generator(dev, args.seed, i))
               for i in range(args.batches)]
    iwae_step = iwae_imgs = None
    if args.iwae:
        # floor-free posterior, matching the training loop's in-loop
        # IWAE protocol (train/loop.py, the iwae step)
        iwae_step = make_iwae_eval_step(
            cfg, state.model.with_config(
                dataclasses.replace(cfg.model, explore_eps=None)),
            n_particles=5)
        iwae_imgs, _ = synth(args.batch_size,
                             seeded_generator(dev, args.seed, 31))
    out = evaluate_checkpoint(state, batches, make_eval_step(cfg, state.model),
                              iwae_step, iwae_imgs, args.seed)
    return dict(out, restored_step=state.step)


if __name__ == "__main__":
    main()
