"""Multi-digit canvas synthesis on the device.

Per canvas:
  1. ``k ~ Uniform{min_digits .. max_digits}`` digits (the ground-truth
     count, for evaluation only).
  2. Each of the ``max_digits`` slots draws a digit from the bank and a
     scale from ``scale_range``.
  3. Slots get DISTINCT cells of a G×G grid (a per-example random
     permutation) and are jittered inside them: disjoint digit boxes by
     construction.
  4. Slots are pasted with the model's ``st_paste`` (on the card, the
     gather kernel), summed under the slot mask and clipped to [0, 1].

Only grid placement is ported; uniform placement with overlap rejection
comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from attend_infer_repeat_torch import resolve_device
from attend_infer_repeat_torch.configs import DataConfig
from attend_infer_repeat_torch.ops.spatial_transformer import st_paste


def _grid_size(t_slots: int) -> int:
    """Smallest G ≥ 2 with G² ≥ slots."""
    return max(2, math.ceil(math.sqrt(max(t_slots, 1))))


def sample_draws(cfg: DataConfig, batch: int, n_bank: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Dict[str, torch.Tensor]:
    """The random numbers one batch consumes, drawn from ``generator``."""
    t_slots = max(cfg.max_digits, 1)
    g = _grid_size(t_slots)
    lo, hi = cfg.scale_range
    kw = dict(generator=generator, device=device)
    return {
        "nums": torch.randint(cfg.min_digits, cfg.max_digits + 1, (batch,),
                              **kw),
        "idx": torch.randint(0, n_bank, (batch, t_slots), **kw),
        "scale": lo + (hi - lo) * torch.rand((batch, t_slots), **kw),
        "scores": torch.rand((batch, g * g), **kw),
        "jitter": 2.0 * torch.rand((batch, t_slots, 2), **kw) - 1.0,
    }


def synthesize_batch(digit_bank: torch.Tensor, cfg: DataConfig, batch: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None):
    """``(imgs (batch, H, W) float32, nums (batch,) int32)``.

    ``digit_bank (N, dh, dw)`` float32 in [0, 1] on the target device.
    ``draws`` (as ``sample_draws`` returns them) injects the random
    numbers; otherwise they come from ``generator``.
    """
    if cfg.placement != "grid":
        raise NotImplementedError(
            f"placement {cfg.placement!r}: only grid placement is ported")
    ch, cw = cfg.canvas_size
    dh, dw = cfg.digit_size
    t_slots = max(cfg.max_digits, 1)
    dev = digit_bank.device
    if draws is None:
        draws = sample_draws(cfg, batch, digit_bank.shape[0], generator, dev)

    nums = draws["nums"]
    slot = torch.arange(t_slots, device=dev)
    present = (slot[None, :] < nums[:, None]).to(torch.float32)   # (B, T)
    s = draws["scale"]
    sx = s * dw / cw                  # normalized half-extents on the canvas
    sy = s * dh / ch

    # grid placement: argsort of iid uniforms is a uniform permutation
    g = _grid_size(t_slots)
    cell_ids = torch.argsort(draws["scores"], dim=-1)[:, :t_slots]
    row = (cell_ids // g).to(torch.float32)
    col = (cell_ids % g).to(torch.float32)
    cell_w = 2.0 / g
    cx = -1.0 + (col + 0.5) * cell_w
    cy = -1.0 + (row + 0.5) * cell_w
    # keep the digit box inside its cell, with a margin; pin to the center
    # when the box is bigger than the cell
    margin = cfg.cell_margin * cell_w
    free_x = torch.clamp(cell_w / 2 - sx - margin, min=0.0)
    free_y = torch.clamp(cell_w / 2 - sy - margin, min=0.0)
    u = draws["jitter"]
    tx = cx + u[..., 0] * free_x
    ty = cy + u[..., 1] * free_y

    z_where = torch.stack([sx, sy, tx, ty], dim=-1)              # (B, T, 4)
    glimpses = digit_bank[draws["idx"]]                          # (B, T, dh, dw)
    pastes = st_paste(glimpses, z_where, (ch, cw))               # (B, T, H, W)
    imgs = torch.clamp(torch.sum(pastes * present[..., None, None], dim=1),
                       0.0, 1.0)
    return imgs, nums.to(torch.int32)


def make_synth_fn(cfg: DataConfig, digit_bank, device=None):
    """``(batch, generator=None) → (imgs, nums)`` with the bank on ``device``."""
    bank = torch.as_tensor(digit_bank, dtype=torch.float32).to(
        resolve_device(device))

    @torch.inference_mode()
    def synth(batch: int, generator: Optional[torch.Generator] = None):
        return synthesize_batch(bank, cfg, batch, generator)

    return synth
