"""Multi-digit canvases: the digit bank and grid synthesis, in plain PyTorch.

The bank is the UCI optical-recognition digits (1,797 8x8 images, values
0-16, the copy in ``air_bench/data/digits_8x8.npz``): the first 90 % of
them, bilinearly upsampled to the configured digit size, contrast
restored by 1.6 and clipped to [0, 1].

A canvas draws its count ``k ~ U{min_digits .. max_digits}``, a bank
digit and a scale for each of ``max_digits`` slots, and distinct cells of
a GxG grid (the argsort of uniform scores) jittered inside the cell's
free margin; each slot's digit is pasted at its window and the present
slots summed and clipped to [0, 1].  The draws come from one generator in
a fixed order (count, digit, scale, scores, jitter), the order in which
the trained program draws them.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from air_bench.reference import st
from air_bench.reference.precision import Precision

BANK = Path(__file__).resolve().parent.parent / "data" / "digits_8x8.npz"


def digit_bank(digit_size, device) -> torch.Tensor:
    """``(N, dh, dw)`` float32 digits on ``device``."""
    with np.load(BANK) as blob:
        imgs = torch.from_numpy(blob["images"].astype(np.float32) / 16.0)
    imgs = imgs[:-(len(imgs) // 10)]
    up = F.interpolate(imgs[:, None], size=tuple(digit_size),
                       mode="bilinear", align_corners=False)[:, 0]
    return torch.clamp(up * 1.6, 0.0, 1.0).contiguous().to(device)


def _grid(slots: int) -> int:
    return max(2, math.ceil(math.sqrt(max(slots, 1))))


def synthesize(bank: torch.Tensor, data: dict, batch: int,
               generator: torch.Generator, prec: Precision | None = None):
    """``(imgs (batch, H, W) float32, nums (batch,) int32)`` by grid
    placement, drawn from ``generator``."""
    if data["placement"] != "grid":
        raise NotImplementedError("the reference synthesizes grid scenes")
    prec = prec or Precision()
    dev = bank.device
    ch, cw = data["canvas_size"]
    dh, dw = data["digit_size"]
    slots = max(data["max_digits"], 1)
    lo, hi = data["scale_range"]
    g = _grid(slots)
    kw = dict(generator=generator, device=dev)
    nums = torch.randint(data["min_digits"], data["max_digits"] + 1,
                         (batch,), **kw)
    idx = torch.randint(0, bank.shape[0], (batch, slots), **kw)
    scale = lo + (hi - lo) * torch.rand((batch, slots), **kw)
    scores = torch.rand((batch, g * g), **kw)
    jitter = 2.0 * torch.rand((batch, slots, 2), **kw) - 1.0

    present = (torch.arange(slots, device=dev)[None, :]
               < nums[:, None]).to(torch.float32)
    sx, sy = scale * dw / cw, scale * dh / ch
    cell = torch.argsort(scores, dim=-1)[:, :slots]
    row, col = (cell // g).to(torch.float32), (cell % g).to(torch.float32)
    width = 2.0 / g
    margin = data["cell_margin"] * width
    free_x = torch.clamp(width / 2 - sx - margin, min=0.0)
    free_y = torch.clamp(width / 2 - sy - margin, min=0.0)
    tx = -1.0 + (col + 0.5) * width + jitter[..., 0] * free_x
    ty = -1.0 + (row + 0.5) * width + jitter[..., 1] * free_y
    zw = torch.stack([sx, sy, tx, ty], dim=-1).reshape(-1, 4)
    pasted = st.paste(bank[idx].reshape(-1, dh, dw), zw, (ch, cw), prec)
    imgs = torch.clamp(torch.sum(
        pasted.reshape(batch, slots, ch, cw) * present[..., None, None],
        dim=1), 0.0, 1.0)
    return imgs, nums.to(torch.int32)
