"""Measure the realized overlap of the synthetic data with the PyTorch
port.

The port's counterpart of ``scripts/characterize_overlap.py``, with the
same flags, dict keys, histogram edges and markdown table, plus
``--device`` (default ``cuda``; with no card it raises unless given
``--device cpu``).  For each named preset it synthesizes ``--n`` canvases
in chunks of 8192 (the paste kernel runs at N = 8192 × slots on the card)
and reports, over the scenes with at least two digits: the pairwise-IoU
histogram of the placed digit boxes, the share of pairs and scenes whose
boxes overlap (IoU > 0) or touch (box gap ≤ 1 px), and the mean, median,
90th percentile and largest IoU.

    python3 scripts/torch_characterize_overlap.py --configs \\
        canonical_uniform canonical_uniform28 canonical_fast --n 65536

Chunk ``i`` (its first canvas's index) is synthesized from a generator
seeded from ``(seed, i)``: the JAX script's ``fold_in(key(seed), i)``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch import resolve_device  # noqa: E402
from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    synthesize_batch,
)
from attend_infer_repeat_torch.data.synth import _pairwise_iou  # noqa: E402
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402

CHUNK = 8192
SCENE_CHUNK = 16384
HIST_EDGES = [0, 1e-9, 0.05, 0.1, 0.15, 0.2, 0.25, 0.35, 0.5, 1.0]
TABLE_COLS = ["config", "pct_scenes_overlapping", "pct_scenes_touching_1px",
              "pct_pairs_overlapping", "iou_mean", "iou_p50", "iou_p90",
              "iou_max"]


def pair_iou(meta, a: int, b: int) -> np.ndarray:
    """The IoU of slots ``a`` and ``b``'s boxes in each scene of ``meta``
    (numpy arrays, as ``synthesize_batch(return_meta=True)`` gives them)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(meta[k]))
         for k in ("sx", "sy", "tx", "ty")}
    return _pairwise_iou(t["tx"][:, a], t["ty"][:, a], t["sx"][:, a],
                         t["sy"][:, a], t["tx"][:, b], t["ty"][:, b],
                         t["sx"][:, b], t["sy"][:, b]).numpy()


@torch.inference_mode()
def synthesize_meta(cfg, bank, n: int, seed: int = 0, draws=None) -> dict:
    """Each slot's placement over ``n`` canvases of ``cfg.data``, synthesized
    in chunks of ``CHUNK`` on ``bank``'s device, as numpy arrays.
    ``draws(i, b)`` injects chunk ``i``'s random numbers (its first
    canvas's index ``i``, ``b`` canvases)."""
    chunks = []
    for i in range(0, n, CHUNK):
        b = min(CHUNK, n - i)
        _, _, m = synthesize_batch(
            bank, cfg.data, b, seeded_generator(bank.device, seed, i),
            draws=None if draws is None else draws(i, b), return_meta=True)
        chunks.append({k: v.cpu().numpy() for k, v in m.items()})
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def overlap_stats(config_name: str, cfg, meta: dict) -> dict:
    """The JAX script's statistics of ``meta``'s digit boxes."""
    sx, sy, tx, ty = (meta[k] for k in ("sx", "sy", "tx", "ty"))
    present = meta["present"] > 0                            # (B, T)
    n, t = sx.shape
    ch, cw = cfg.data.canvas_size
    pair_ious, pair_gaps = [], []                            # per digit pair
    scene_max_iou, scene_min_gap = [], []                    # per ≥2 scene
    for lo in range(0, n, SCENE_CHUNK):
        pp = present[lo:lo + SCENE_CHUNK]
        multi = pp.sum(1) >= 2
        if not multi.any():
            continue
        part = {k: meta[k][lo:lo + SCENE_CHUNK][multi]
                for k in ("sx", "sy", "tx", "ty")}
        pp = pp[multi]
        psx, psy, ptx, pty = (part[k] for k in ("sx", "sy", "tx", "ty"))
        ious, gaps = [], []
        for i in range(t):
            for j in range(i + 1, t):
                both = pp[:, i] & pp[:, j]
                iou = pair_iou(part, i, j)
                # box gap in pixels: the larger per-axis separation less
                # the summed half-extents (negative: the boxes overlap on
                # both axes)
                gx = np.abs(ptx[:, i] - ptx[:, j]) - (psx[:, i] + psx[:, j])
                gy = np.abs(pty[:, i] - pty[:, j]) - (psy[:, i] + psy[:, j])
                gap_px = np.maximum(gx * cw / 2, gy * ch / 2)
                pair_ious.append(iou[both])
                pair_gaps.append(gap_px[both])
                ious.append(np.where(both, iou, -np.inf))
                gaps.append(np.where(both, gap_px, np.inf))
        scene_max_iou.append(np.max(np.stack(ious), axis=0))
        scene_min_gap.append(np.min(np.stack(gaps), axis=0))

    pair_iou_all = np.concatenate(pair_ious)
    pair_gap = np.concatenate(pair_gaps)
    scene_max_iou = np.concatenate(scene_max_iou)
    scene_min_gap = np.concatenate(scene_min_gap)
    hist, edges = np.histogram(pair_iou_all, bins=HIST_EDGES)
    return {
        "config": config_name,
        "n_scenes": int(n),
        "n_multi_scenes": int(len(scene_max_iou)),
        "n_digit_pairs": int(len(pair_iou_all)),
        "pct_pairs_overlapping": round(100.0 * float(
            (pair_iou_all > 0).mean()), 2),
        "pct_pairs_touching_1px": round(100.0 * float(
            (pair_gap <= 1.0).mean()), 2),
        "pct_scenes_overlapping": round(100.0 * float(
            (scene_max_iou > 0).mean()), 2),
        "pct_scenes_touching_1px": round(100.0 * float(
            (scene_min_gap <= 1.0).mean()), 2),
        "iou_mean": round(float(pair_iou_all.mean()), 4),
        "iou_p50": round(float(np.percentile(pair_iou_all, 50)), 4),
        "iou_p90": round(float(np.percentile(pair_iou_all, 90)), 4),
        "iou_max": round(float(pair_iou_all.max()), 4),
        "iou_hist_edges": [float(e) for e in edges],
        "iou_hist_pct": [round(100.0 * float(h) / max(len(pair_iou_all), 1),
                               2) for h in hist],
    }


def characterize(config_name: str, n: int, seed: int = 0, device=None,
                 draws=None) -> dict:
    """``overlap_stats`` of ``n`` canvases of the preset ``config_name``
    synthesized on ``device`` (``draws`` as ``synthesize_meta`` takes
    them)."""
    cfg = get_config(config_name)
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
    meta = synthesize_meta(cfg, bank.to(resolve_device(device)), n, seed,
                           draws)
    return overlap_stats(config_name, cfg, meta)


def main(argv=None) -> list:
    """Characterize each preset; returns the rows written to ``--out``."""
    p = argparse.ArgumentParser()
    p.add_argument("--configs", nargs="+",
                   default=["canonical_fast", "canonical_uniform",
                            "canonical_uniform28"])
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--out", default="runs/overlap_characterization.json")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to synthesize (default cuda; never falls "
                        "back)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    rows = [characterize(c, args.n, device=dev) for c in args.configs]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    # markdown table for PARITY.md
    print("| " + " | ".join(TABLE_COLS) + " |")
    print("|" + "---|" * len(TABLE_COLS))
    for r in rows:
        print("| " + " | ".join(str(r[c]) for c in TABLE_COLS) + " |")
    print("saved", args.out, flush=True)
    return rows


if __name__ == "__main__":
    main()
