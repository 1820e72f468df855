"""Bin a trained run's count errors by the digits' true overlap, with the
PyTorch port.

The port's counterpart of ``scripts/analyze_overlap_errors.py``, with the
same flags and output plus ``--device`` (default ``cuda``; with no card
it raises unless given ``--device cpu``).  It restores
``<workdir>/ckpt`` (the latest step), evaluates ``--batches`` held-out
batches of the eval-split digit bank through ``make_eval_step``, and bins
MAP-count (``mode_steps``) correctness by each scene's largest pairwise
IoU of its true digit boxes (``IOU_EDGES``; scenes with fewer than two
digits form the ``<2 digits`` bin).  It prints each bin's accuracy, its
share of all errors and its most frequent error, the overall accuracy and
the accuracy left if only the errors at IoU ≥ 0.3, 0.4 or 0.5 remained.

    python3 scripts/torch_analyze_overlap_errors.py \\
        --config canonical_uniform28 --workdir runs/u28_seed0 \\
        --train-seed 0 --batches 16

Held-out batch ``i`` is synthesized from a generator seeded from ``(seed,
i)`` and its forward noise drawn from ``(seed, 10000 + i)``: the JAX
script's ``fold_in`` integers.  ``scripts/torch_supervised_ceiling.py``
bins its predictions on the same scenes with ``overlap_bins``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))
sys.path.insert(0, _SCRIPTS)

from attend_infer_repeat_torch import resolve_device  # noqa: E402
from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    synthesize_batch,
)
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402
from attend_infer_repeat_torch.train import make_eval_step  # noqa: E402
from torch_characterize_overlap import pair_iou  # noqa: E402
from torch_eval_checkpoint import restore_state  # noqa: E402

IOU_EDGES = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 1.0000001]
TABLE_COLS = ["bin", "n_scenes", "pct_scenes", "accuracy",
              "pct_of_all_errors", "dominant_error"]


def scene_max_iou(meta) -> np.ndarray:
    """Each scene's largest IoU over its pairs of present digits, -1 for a
    scene with fewer than two (``meta``: numpy arrays, as
    ``synthesize_batch(return_meta=True)`` gives them)."""
    present = np.asarray(meta["present"]) > 0
    t_slots = present.shape[1]
    best = np.full(present.shape[0], -1.0)
    for a in range(t_slots):
        for b in range(a + 1, t_slots):
            both = present[:, a] & present[:, b]
            best = np.where(both, np.maximum(best, pair_iou(meta, a, b)),
                            best)
    return best


def overlap_bins(max_iou, true_n, pred_n) -> dict:
    """Count correctness binned by ``max_iou`` (``scene_max_iou``):
    ``table`` (a row a non-empty bin), the overall ``accuracy`` and the
    ``ceilings`` if only the errors at IoU ≥ 0.3, 0.4, 0.5 remained."""
    correct = true_n == pred_n
    n = len(correct)
    n_err = int((~correct).sum())
    rows = [("<2 digits", max_iou < 0)]
    for lo, hi in zip(IOU_EDGES[:-1], IOU_EDGES[1:]):
        rows.append((f"IoU [{lo:.1f},{min(hi, 1.0):.1f})",
                     (max_iou >= lo) & (max_iou < hi)))
    table = []
    for label, sel in rows:
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        errs = sel & ~correct
        mode = ""
        if errs.any():
            kinds, counts = np.unique(
                [f"{t}->{p}" for t, p in zip(true_n[errs], pred_n[errs])],
                return_counts=True)
            mode = str(kinds[np.argmax(counts)])
        table.append({"bin": label, "n_scenes": cnt,
                      "pct_scenes": round(100.0 * cnt / n, 2),
                      "accuracy": round(float(correct[sel].mean()), 4),
                      "pct_of_all_errors": round(
                          100.0 * float(errs.sum()) / max(n_err, 1), 2),
                      "dominant_error": mode})
    # if every scene below the threshold were counted right, the accuracy
    # left (the errors at or above it taken as intrinsic)
    ceilings = {f"ceiling_if_only_iou>={thr}_errors": round(
        1.0 - float(((max_iou >= thr) & ~correct).sum()) / n, 4)
        for thr in (0.3, 0.4, 0.5)}
    return {"table": table, "accuracy": float(correct.mean()),
            "ceilings": ceilings}


def print_table(table) -> None:
    print("| " + " | ".join(TABLE_COLS) + " |")
    print("|" + "---|" * len(TABLE_COLS))
    for r in table:
        print("| " + " | ".join(str(r[c]) for c in TABLE_COLS) + " |",
              flush=True)


@torch.inference_mode()
def heldout_scenes(cfg, bank, batches: int, batch_size: int, seed: int):
    """``(imgs, nums, meta)`` of the held-out batches on ``bank``'s device,
    batch ``i`` from a generator seeded from ``(seed, i)``."""
    return [synthesize_batch(bank, cfg.data, batch_size,
                             seeded_generator(bank.device, seed, i),
                             return_meta=True) for i in range(batches)]


def count_by_overlap(state, eval_step, scenes, seed: int):
    """``(max_iou, true counts, MAP counts)`` over ``scenes``
    (``heldout_scenes``), batch ``i``'s noise from a generator seeded from
    ``(seed, 10000 + i)``."""
    dev = state.model.device
    max_ious, trues, preds = [], [], []
    for i, (imgs, nums, meta) in enumerate(scenes):
        _, outputs = eval_step(state, imgs, nums,
                               seeded_generator(dev, seed, 10_000 + i))
        max_ious.append(scene_max_iou(
            {k: v.cpu().numpy() for k, v in meta.items()}))
        trues.append(nums.cpu().numpy().astype(int))
        preds.append(outputs.mode_steps.cpu().numpy().astype(int))
    return tuple(np.concatenate(a) for a in (max_ious, trues, preds))


def main(argv=None) -> dict:
    """Run the analysis; returns what it wrote to ``--out``."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical_uniform28")
    p.add_argument("--workdir", required=True)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--train-seed", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to evaluate (default cuda; never falls "
                        "back)")
    p.add_argument("--out", default=None,
                   help="JSON output path (default runs/<workdir>_overlap_"
                        "errors.json)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.train_seed is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, seed=args.train_seed))
    state = restore_state(cfg, args.workdir, device=dev)
    print(f"restored step {state.step}", flush=True)
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size,
                              split="eval")
    scenes = heldout_scenes(cfg, bank.to(dev), args.batches,
                            args.batch_size, args.seed)
    max_iou, true_n, pred_n = count_by_overlap(
        state, make_eval_step(cfg, state.model), scenes, args.seed)
    bins = overlap_bins(max_iou, true_n, pred_n)
    out = {"config": args.config, "workdir": args.workdir,
           "step": int(state.step), "n_scenes": len(true_n),
           "overall_mode_accuracy": round(bins["accuracy"], 4),
           "bins": bins["table"], **bins["ceilings"]}

    print_table(bins["table"])
    print(json.dumps({k: v for k, v in out.items() if k != "bins"},
                     indent=1))
    out_path = args.out or os.path.join(
        "runs", os.path.basename(args.workdir.rstrip("/"))
        + "_overlap_errors.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print("saved", out_path, flush=True)
    return out


if __name__ == "__main__":
    main()
