"""The importance-weighted bound against the number of particles k on a
trained run's checkpoint, with the PyTorch port.

The port's counterpart of ``scripts/iwae_ksweep.py``, with the same flags
and output plus ``--device`` (default ``cuda``; with no card it raises
unless given ``--device cpu``).  For each k of ``--ks`` it runs
``make_iwae_eval_step(cfg, model, n_particles=k)`` of the floor-free model
(``explore_eps=None``, as the training loop's IWAE) over ``--batches``
held-out batches, prints one JSON row per k with the mean bound, then
``monotone_in_k``: whether each bound is at least the one before it less
0.5 nats (the IWAE bound grows with k in expectation; Burda et al. 2016,
Thm 1).

    python3 scripts/torch_iwae_ksweep.py --config iwae --workdir runs/iwae_r5

Held-out batch ``i`` is synthesized from a generator seeded from ``(seed,
1000 + i)``, the same for every k; particle draws for k come from ``(seed,
131·k + i)``: the JAX script's ``fold_in`` integers.  On the card each k
has its own CUDA graph (one forward at batch k·batch-size); its memory
pool is printed and freed before the next k.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

import torch

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))
sys.path.insert(0, _SCRIPTS)

from attend_infer_repeat_torch import resolve_device  # noqa: E402
from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    make_synth_fn,
)
from attend_infer_repeat_torch.eval import make_iwae_eval_step  # noqa: E402
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402
from torch_eval_checkpoint import restore_state  # noqa: E402


def monotone(rows) -> dict:
    """The JAX script's last line: whether each bound is at least the one
    before it less 0.5 nats, the ks and the bounds."""
    bounds = [r["iwae_bound"] for r in rows]
    mono = all(b2 >= b1 - 0.5 for b1, b2 in zip(bounds, bounds[1:]))
    return {"monotone_in_k": mono, "ks": [r["k"] for r in rows],
            "bounds": bounds}


def sweep(state, make_step, imgs, ks, seed: int) -> list:
    """One row per k: the mean ``iwae_bound`` of ``make_step(k)`` (an
    IWAE eval step of k particles) over the batches ``imgs``, batch ``i``'s
    draws from a generator seeded from ``(seed, 131·k + i)``.  Prints each
    row, and each k's graph pool, freed before the next k."""
    dev = state.model.device
    rows = []
    for k in ks:
        step = make_step(k)
        vals = [float(step(state, im, seeded_generator(dev, seed,
                                                        k * 131 + i))
                      ["iwae_bound"]) for i, im in enumerate(imgs)]
        rows.append({"k": k, "iwae_bound": round(sum(vals) / len(vals), 3),
                     "n_images": sum(im.shape[0] for im in imgs)})
        print(json.dumps(rows[-1]), flush=True)
        pools = [e.graph.pool_bytes
                 for e in getattr(step, "graphs", {}).values()]
        if pools:
            del step
            gc.collect()
            torch.cuda.empty_cache()
            print(f"k={k}: graph pool {sum(pools) / 2**20:.1f} MiB, freed",
                  flush=True)
    return rows


def main(argv=None) -> dict:
    """Run the sweep; returns ``{"rows", "monotone"}``."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="iwae")
    p.add_argument("--workdir", required=True)
    p.add_argument("--ks", type=int, nargs="+", default=[1, 5, 25])
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--seed", type=int, default=4321)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to evaluate (default cuda; never falls "
                        "back)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    state = restore_state(cfg, args.workdir, device=dev)
    print(f"restored step {state.step}", flush=True)
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size,
                              split="eval")
    synth = make_synth_fn(cfg.data, bank, device=dev)
    imgs = [synth(args.batch_size, seeded_generator(dev, args.seed, 1000 + i))
            [0] for i in range(args.batches)]
    # floor-free posterior, the training loop's IWAE protocol
    iwae_model = state.model.with_config(
        dataclasses.replace(cfg.model, explore_eps=None))
    rows = sweep(state, lambda k: make_iwae_eval_step(cfg, iwae_model,
                                                      n_particles=k),
                 imgs, args.ks, args.seed)
    mono = monotone(rows)
    print(json.dumps(mono), flush=True)
    return {"rows": rows, "monotone": mono}


if __name__ == "__main__":
    main()
