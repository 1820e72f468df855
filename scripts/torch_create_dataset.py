"""Write the reference-format dataset pickles with the PyTorch port.

The port's counterpart of ``scripts/create_dataset.py``, with the same
flags, defaults and output, plus ``--device`` (default ``cuda``; with no
card it raises unless given ``--device cpu``).  Writes
``mnist_train.pickle`` from the digit bank's ``train`` split and
``mnist_validation.pickle`` from its ``eval`` split, each ``{"imgs": (N,
H, W) float32, "nums": (N,) int32}``, the reference's keys, which
``python -m attend_infer_repeat_torch.train --data ... --eval-data ...``
reads.

Canvases are synthesized on the device through ``make_synth_fn`` (on the
card one CUDA graph per split, one synthesis-paste launch per call),
``--chunk`` at a time; the last chunk is synthesized whole and cut.
Chunk ``i`` of the train split draws from a generator seeded from
``(seed, i)``, of the validation split from ``(seed + 1, i)``: the JAX
script's keys, with ``seeded_generator`` for ``fold_in``.  So one seed
writes the same bytes on every run, and a longer split begins with a
shorter one's rows.

    python3 scripts/torch_create_dataset.py --outdir data --n-train 60000
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch import resolve_device  # noqa: E402
from attend_infer_repeat_torch.configs import DataConfig  # noqa: E402
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    make_synth_fn,
)
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402


def main(argv=None) -> dict:
    """Write both pickles; returns ``{tag: {"path", "histogram"}}``."""
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="data")
    p.add_argument("--n-train", type=int, default=60_000)
    p.add_argument("--n-validation", type=int, default=10_000)
    p.add_argument("--canvas-size", type=int, default=50)
    p.add_argument("--min-digits", type=int, default=0)
    p.add_argument("--max-digits", type=int, default=2)
    p.add_argument("--chunk", type=int, default=4096,
                   help="device batch per synthesis call")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--source", default="auto",
                   help='"auto" (bundled digits) or "mnist:<path>"')
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to synthesize (default cuda; never falls "
                        "back)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = DataConfig(
        canvas_size=(args.canvas_size, args.canvas_size),
        min_digits=args.min_digits, max_digits=args.max_digits,
        source=args.source)
    os.makedirs(args.outdir, exist_ok=True)

    written = {}
    for split, n, tag in (("train", args.n_train, "mnist_train"),
                          ("eval", args.n_validation, "mnist_validation")):
        bank, _ = load_digit_bank(cfg.source, cfg.digit_size, split=split)
        synth = make_synth_fn(cfg, bank, device=dev)
        seed = args.seed if split == "train" else args.seed + 1
        imgs = np.empty((n, *cfg.canvas_size), np.float32)
        nums = np.empty((n,), np.int32)
        for i, lo in enumerate(range(0, n, args.chunk)):
            take = min(args.chunk, n - lo)
            im, nm = synth(args.chunk, seeded_generator(dev, seed, i))
            imgs[lo:lo + take] = im[:take].cpu().numpy()
            nums[lo:lo + take] = nm[:take].cpu().numpy()
        blob = {"imgs": imgs, "nums": nums}
        path = os.path.join(args.outdir, f"{tag}.pickle")
        with open(path, "wb") as f:
            pickle.dump(blob, f)
        hist = np.bincount(nums)
        print(f"wrote {path}: imgs {imgs.shape}, count histogram {hist}",
              flush=True)
        written[tag] = {"path": path, "histogram": hist.tolist()}
    return written


if __name__ == "__main__":
    main()
