"""Figure: explain-away on touching digits, with the PyTorch port.

The port's counterpart of ``scripts/make_explainaway_fig.py``, with the
same flags plus ``--device`` (default ``cuda``; with no card it raises
unless given ``--device cpu``).  It restores the run's latest checkpoint,
synthesizes 2-digit canvases from the digit bank's ``eval`` split,
selects the scenes whose two INFERRED attention windows overlap
(``select_scenes``) and saves the input/reconstruction/attention-box grid
with ``make_fig``, which needs matplotlib: without it the script raises
matplotlib's ``ImportError`` once the scenes are selected.

    python3 scripts/torch_make_explainaway_fig.py --workdir runs/uniform \\
        --out docs/explain_away_fig.png

The canvases draw from a generator seeded from 17, the eval step's noise
from 23 (the JAX script's keys).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

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
from attend_infer_repeat_torch.data.synth import _pairwise_iou  # noqa: E402
from attend_infer_repeat_torch.eval import make_fig  # noqa: E402
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402
from attend_infer_repeat_torch.train import (  # noqa: E402
    create_train_state,
    make_eval_step,
    restore_latest,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical_uniform")
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", default="docs/explain_away_fig.png")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--min-iou", type=float, default=0.02,
                   help="min IoU between the two inferred windows")
    p.add_argument("--model-set", action="append", metavar="KEY=VALUE",
                   help="ModelConfig overrides matching the trained "
                        "variant (same syntax as torch_eval_checkpoint.py)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run the model (default cuda; never "
                        "falls back)")
    return p.parse_args(argv)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def select_scenes(z_where, pres, mode_steps, max_scale=None,
                  min_iou: float = 0.02, limit: int = 8):
    """``(indices, iou)``: the scenes whose first two windows are both
    present, counted 2 (MAP) and overlap by at least ``min_iou``, largest
    IoU first, at most ``limit``; and every scene's IoU.

    ``z_where (B, T, 4)`` as ``(sx, sy, tx, ty)``, ``pres (B, T)``,
    ``mode_steps (B,)``, as arrays or tensors.  The scales are clipped at
    ``max_scale`` first, as the model's window is: a raw sample above the
    cap would overstate the window.
    """
    zw = _numpy(z_where).copy()
    if max_scale is not None:
        zw[..., :2] = np.minimum(zw[..., :2], max_scale)
    pres, pred = _numpy(pres), _numpy(mode_steps)
    a, b = torch.from_numpy(zw[:, 0]), torch.from_numpy(zw[:, 1])
    iou = _pairwise_iou(a[:, 2], a[:, 3], a[:, 0], a[:, 1],
                        b[:, 2], b[:, 3], b[:, 0], b[:, 1]).numpy()
    both = (pres[:, 0] > 0) & (pres[:, 1] > 0)
    sel = np.where(both & (pred == 2) & (iou >= min_iou))[0]
    return sel[np.argsort(-iou[sel])][:limit], iou


def find_scenes(args) -> dict:
    """Restore, run the eval step on 2-digit canvases, select the scenes;
    returns what ``render`` draws (``imgs``, ``nums``, ``outputs``,
    ``sel``, ``iou``, ``max_scale``) and the ``restored_step``."""
    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    cfg = dataclasses.replace(
        cfg, model=apply_overrides(cfg.model, args.model_set))
    dcfg = dataclasses.replace(cfg.data, min_digits=2, max_digits=2)
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size,
                              split="eval")
    imgs, nums = make_synth_fn(dcfg, bank, device=dev)(
        args.batch, seeded_generator(dev, 17))
    state = restore_latest(os.path.join(args.workdir, "ckpt"),
                           create_train_state(cfg, device=dev))
    if state is None:
        raise SystemExit(f"no checkpoint under {args.workdir}/ckpt")
    print("restored step", state.step, flush=True)

    _, out = make_eval_step(cfg, state.model)(state, imgs, nums,
                                              seeded_generator(dev, 23))
    sel, iou = select_scenes(out.steps.z_where, out.steps.pres,
                             out.mode_steps, cfg.model.max_scale,
                             args.min_iou)
    print(f"{len(sel)} touching-digit scenes (IoU up to "
          f"{iou[sel].max() if len(sel) else 0:.2f})", flush=True)
    return {"imgs": imgs, "nums": nums, "outputs": out, "sel": sel,
            "iou": iou, "max_scale": cfg.model.max_scale,
            "restored_step": state.step}


def _take(x, idx, batch):
    """The rows ``idx`` of every batch-major tensor in an output nest."""
    if isinstance(x, torch.Tensor) and x.shape[:1] == (batch,):
        return x[idx.to(x.device)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _take(getattr(x, f.name), idx, batch)
            for f in dataclasses.fields(x)})
    return x


def render(scenes: dict, path: str) -> str:
    """``make_fig`` of the selected scenes at ``path`` (needs matplotlib:
    raises its ``ImportError`` without it)."""
    idx = torch.as_tensor(scenes["sel"], dtype=torch.int64)
    batch = scenes["imgs"].shape[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return make_fig(_numpy(scenes["imgs"])[scenes["sel"]],
                    _take(scenes["outputs"], idx, batch), path,
                    true_nums=_numpy(scenes["nums"])[scenes["sel"]],
                    max_scale=scenes["max_scale"])


def main(argv=None) -> dict:
    """Select the scenes and save the figure; returns ``find_scenes``'
    dict."""
    args = parse_args(argv)
    scenes = find_scenes(args)
    if not len(scenes["sel"]):
        raise SystemExit("no overlapping-window scenes found")
    render(scenes, args.out)
    print("saved", args.out, flush=True)
    return scenes


if __name__ == "__main__":
    main()
