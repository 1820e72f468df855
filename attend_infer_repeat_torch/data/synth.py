"""Multi-digit canvas synthesis on the device.

Per canvas:
  1. ``k ~ Uniform{min_digits .. max_digits}`` digits (the ground-truth
     count, for evaluation only).
  2. Each of the ``max_digits`` slots draws a digit from the bank and a
     scale from ``scale_range``.
  3. Positions: with ``placement="grid"`` slots get DISTINCT cells of a
     G×G grid (a per-example random permutation) and are jittered inside
     them, so digit boxes are disjoint by construction; with
     ``"uniform"`` each slot takes the first of ``place_attempts``
     uniform in-bounds candidates whose worst IoU against the slots
     placed before it is at most ``overlap_iou_max``, else the last
     candidate (soft rejection: overlap happens).
  4. Slots are pasted with the model's ``st_paste`` (on the card, the
     gather kernel), summed under the slot mask and clipped to [0, 1].

``make_synth_fn`` takes the draws first and synthesizes from them through
a ``utils.graphs.GraphCache``: one CUDA graph per batch on the card,
eager where ``utils.graphs.eager`` holds.

``synthesize_sequences`` makes moving-digit sequences for Sequential AIR
(``models/sqair.py``): each digit of a sequence moves at a constant
velocity, bounces off the canvas's edges and enters at a frame of its
own; every frame of every digit is pasted in one call.

``synthesize_scenes`` makes RGB scenes for SPACE (``models/space.py``):
three flat colours split by a horizon and a wall's split, then coloured
digits composited back to front.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from attend_infer_repeat_torch import resolve_device
from attend_infer_repeat_torch.configs import (
    DataConfig,
    SequenceConfig,
    SpaceConfig,
)
from attend_infer_repeat_torch.ops.spatial_transformer import st_paste
from attend_infer_repeat_torch.utils import graphs
from attend_infer_repeat_torch.utils.profiling import span


def _grid_size(t_slots: int) -> int:
    """Smallest G ≥ 2 with G² ≥ slots."""
    return max(2, math.ceil(math.sqrt(max(t_slots, 1))))


def sample_draws(cfg: DataConfig, batch: int, n_bank: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Dict[str, torch.Tensor]:
    """The random numbers one batch consumes, drawn from ``generator``.

    Grid placement draws cell ``scores`` and ``jitter``; uniform placement
    draws ``candidates (batch, slots, place_attempts, 2)`` in [-1, 1].
    """
    t_slots = max(cfg.max_digits, 1)
    lo, hi = cfg.scale_range
    kw = dict(generator=generator, device=device)
    draws = {
        "nums": torch.randint(cfg.min_digits, cfg.max_digits + 1, (batch,),
                              **kw),
        "idx": torch.randint(0, n_bank, (batch, t_slots), **kw),
        "scale": lo + (hi - lo) * torch.rand((batch, t_slots), **kw),
    }
    if cfg.placement == "uniform":
        draws["candidates"] = 2.0 * torch.rand(
            (batch, t_slots, cfg.place_attempts, 2), **kw) - 1.0
    else:
        g = _grid_size(t_slots)
        draws["scores"] = torch.rand((batch, g * g), **kw)
        draws["jitter"] = 2.0 * torch.rand((batch, t_slots, 2), **kw) - 1.0
    return draws


def synthesize_batch(digit_bank: torch.Tensor, cfg: DataConfig, batch: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None,
                     return_meta: bool = False):
    """``(imgs (batch, H, W) float32, nums (batch,) int32)``.

    ``digit_bank (N, dh, dw)`` float32 in [0, 1] on the target device.
    ``draws`` (as ``sample_draws`` returns them) injects the random
    numbers; otherwise they come from ``generator``.  With ``return_meta``
    also a dict of each slot's placement, ``(batch, slots)`` float32 each:
    the normalized half-extents ``sx``/``sy``, the centers ``tx``/``ty``
    and the ``present`` mask (for the overlap analyses).
    """
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

    if cfg.placement == "uniform":
        tx, ty = _uniform_positions(draws["candidates"], sx, sy, cfg)
    else:
        tx, ty = _grid_positions(draws["scores"], draws["jitter"], sx, sy,
                                 cfg, t_slots)

    z_where = torch.stack([sx, sy, tx, ty], dim=-1)              # (B, T, 4)
    glimpses = digit_bank[draws["idx"]]                          # (B, T, dh, dw)
    pastes = st_paste(glimpses, z_where, (ch, cw))               # (B, T, H, W)
    imgs = torch.clamp(torch.sum(pastes * present[..., None, None], dim=1),
                       0.0, 1.0)
    if return_meta:
        return imgs, nums.to(torch.int32), {"sx": sx, "sy": sy, "tx": tx,
                                            "ty": ty, "present": present}
    return imgs, nums.to(torch.int32)


def _grid_positions(scores, jitter, sx, sy, cfg: DataConfig, t_slots: int):
    """Disjoint-by-construction placement: distinct grid cells, jittered."""
    # argsort of iid uniforms is a uniform permutation
    g = _grid_size(t_slots)
    cell_ids = torch.argsort(scores, dim=-1)[:, :t_slots]
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
    return cx + jitter[..., 0] * free_x, cy + jitter[..., 1] * free_y


def _pairwise_iou(ax, ay, aw, ah, bx, by, bw, bh):
    """IoU of axis-aligned boxes given centers and half-extents
    (broadcasting; normalized [-1, 1] canvas coordinates)."""
    ix = torch.clamp(torch.minimum(ax + aw, bx + bw)
                     - torch.maximum(ax - aw, bx - bw), min=0.0)
    iy = torch.clamp(torch.minimum(ay + ah, by + bh)
                     - torch.maximum(ay - ah, by - bh), min=0.0)
    inter = ix * iy
    union = 4.0 * aw * ah + 4.0 * bw * bh - inter
    return inter / torch.clamp(union, min=1e-8)


def _uniform_positions(candidates, sx, sy, cfg: DataConfig):
    """Uniform in-bounds positions with soft overlap rejection.

    Slot t takes the FIRST of its candidates whose worst IoU against slots
    0..t-1 is at most ``overlap_iou_max``, else the last candidate.  The
    slot loop is unrolled over ``max_digits``; shapes stay static.
    """
    batch, t_slots = sx.shape
    n_try = candidates.shape[2]
    cand_x = candidates[..., 0] * torch.clamp(1.0 - sx, min=0.0)[..., None]
    cand_y = candidates[..., 1] * torch.clamp(1.0 - sy, min=0.0)[..., None]

    txs, tys = [], []
    for t in range(t_slots):
        cx, cy = cand_x[:, t], cand_y[:, t]                  # (B, R)
        if txs:
            prev_x = torch.stack(txs, dim=1)                 # (B, t)
            prev_y = torch.stack(tys, dim=1)
            worst = torch.amax(_pairwise_iou(
                cx[:, None, :], cy[:, None, :],
                sx[:, t, None, None], sy[:, t, None, None],
                prev_x[:, :, None], prev_y[:, :, None],
                sx[:, :t, None], sy[:, :t, None]), dim=1)    # (B, R)
            # argmax of an integer mask: the first acceptable candidate
            ok = (worst <= cfg.overlap_iou_max).to(torch.int32)
            pick = torch.where(ok.any(dim=-1), torch.argmax(ok, dim=-1),
                               n_try - 1)
        else:
            pick = torch.zeros((batch,), dtype=torch.int64, device=sx.device)
        txs.append(torch.gather(cx, 1, pick[:, None])[:, 0])
        tys.append(torch.gather(cy, 1, pick[:, None])[:, 0])
    return torch.stack(txs, dim=1), torch.stack(tys, dim=1)


def make_synth_fn(cfg: DataConfig, digit_bank, device=None):
    """``(batch, generator=None) → (imgs, nums)``, the bank on ``device``,
    from draws (``sample_draws``) taken from ``generator``."""
    bank = torch.as_tensor(digit_bank, dtype=torch.float32).to(
        resolve_device(device))
    cache = graphs.GraphCache(lambda bank, draws: synthesize_batch(
        bank, cfg, draws["nums"].shape[0], draws=draws))

    @torch.inference_mode()
    def synth(batch: int, generator: Optional[torch.Generator] = None):
        return cache(bank, sample_draws(cfg, batch, bank.shape[0], generator,
                                        bank.device))

    synth.graphs = cache
    return synth


def sample_sequence_draws(cfg: DataConfig, seq: SequenceConfig, batch: int,
                          n_bank: int,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> Dict[str, torch.Tensor]:
    """The random numbers one batch of sequences consumes, drawn from
    ``generator`` in this order: the count, each slot's digit, scale,
    entry frame, start (a fraction of the free range on each axis), speed
    (pixels a frame) and direction."""
    t_slots = max(cfg.max_digits, 1)
    lo, hi = cfg.scale_range
    shape = (batch, t_slots)
    kw = dict(generator=generator, device=device)
    return {
        "nums": torch.randint(cfg.min_digits, cfg.max_digits + 1, (batch,),
                              **kw),
        "idx": torch.randint(0, n_bank, shape, **kw),
        "scale": lo + (hi - lo) * torch.rand(shape, **kw),
        "entry": torch.randint(0, seq.max_entry_frame + 1, shape, **kw),
        "start": torch.rand(shape + (2,), **kw),
        "speed": seq.min_speed + (seq.max_speed - seq.min_speed)
        * torch.rand(shape, **kw),
        "angle": (2.0 * math.pi) * torch.rand(shape, **kw),
    }


def _bounce(start, velocity, steps, half):
    """Positions ``(..., T)`` of a point that starts at ``start`` (a
    fraction of the range ``[-(1 - half), 1 - half]``) and moves by
    ``velocity`` a frame for ``steps`` frames, reflected at both ends."""
    span_ = torch.clamp(2.0 * (1.0 - half), min=1e-6)[..., None]
    y = torch.remainder(start[..., None] * span_ + velocity[..., None]
                        * steps, 2.0 * span_)
    return (half - 1.0)[..., None] + span_ - torch.abs(y - span_)


def synthesize_sequences(digit_bank: torch.Tensor, cfg: DataConfig,
                         seq: SequenceConfig, batch: int,
                         generator: Optional[torch.Generator] = None):
    """``(frames (batch, T, H, W) float32, nums (batch,) int32)``.

    A sequence holds ``k ~ Uniform{min_digits .. max_digits}`` digits.
    Slot s's digit enters at its frame ``e_s`` at its start and moves on
    from there, ``speed`` pixels a frame along its direction, bouncing
    inside the canvas; a frame sums its present digits, clipped to
    [0, 1].  The random numbers are ``sample_sequence_draws``' from
    ``generator``.
    """
    with span("data.sequences"):
        ch, cw = cfg.canvas_size
        dh, dw = cfg.digit_size
        t_slots, frames = max(cfg.max_digits, 1), seq.frames
        dev = digit_bank.device
        draws = sample_sequence_draws(cfg, seq, batch, digit_bank.shape[0],
                                      generator, dev)
        t = torch.arange(frames, dtype=torch.float32, device=dev)
        entry = draws["entry"].to(torch.float32)
        steps = torch.clamp(t - entry[..., None], min=0.0)   # (B, S, T)
        s = draws["scale"]
        sx, sy = s * dw / cw, s * dh / ch
        # one pixel is 2 / (n - 1) of the [-1, 1] axis
        vx = draws["speed"] * torch.cos(draws["angle"]) * (2.0 / (cw - 1))
        vy = draws["speed"] * torch.sin(draws["angle"]) * (2.0 / (ch - 1))
        tx = _bounce(draws["start"][..., 0], vx, steps, sx)
        ty = _bounce(draws["start"][..., 1], vy, steps, sy)
        z_where = torch.stack([sx[..., None].expand_as(tx),
                               sy[..., None].expand_as(ty), tx, ty],
                              dim=-1)                        # (B, S, T, 4)
        slot = torch.arange(t_slots, device=dev)
        present = ((slot[None, :] < draws["nums"][:, None])[..., None]
                   & (t >= entry[..., None])).to(torch.float32)  # (B, S, T)
        glimpses = digit_bank[draws["idx"]][:, :, None].expand(
            -1, -1, frames, -1, -1)                     # (B, S, T, dh, dw)
        pastes = st_paste(glimpses, z_where, (ch, cw))       # (B, S, T, H, W)
        imgs = torch.clamp(torch.sum(pastes * present[..., None, None],
                                     dim=1), 0.0, 1.0)
        return imgs, draws["nums"].to(torch.int32)


def sample_scene_draws(cfg: DataConfig, space: SpaceConfig, batch: int,
                       n_bank: int,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, torch.Tensor]:
    """The random numbers one batch of scenes consumes, drawn from
    ``generator`` in this order: the count, the horizon's row, the wall's
    split column, the three background colours, then each slot's digit,
    scale, position (a fraction of the in-bounds range on each axis) and
    colour."""
    t_slots = max(cfg.max_digits, 1)
    lo, hi = cfg.scale_range
    c = space.channels
    shape = (batch, t_slots)
    kw = dict(generator=generator, device=device)
    return {
        "nums": torch.randint(cfg.min_digits, cfg.max_digits + 1, (batch,),
                              **kw),
        "horizon": torch.randint(space.horizon[0], space.horizon[1] + 1,
                                 (batch,), **kw),
        "split": torch.randint(space.wall_split[0], space.wall_split[1] + 1,
                               (batch,), **kw),
        "background": torch.rand((batch, 3, c), **kw),
        "idx": torch.randint(0, n_bank, shape, **kw),
        "scale": lo + (hi - lo) * torch.rand(shape, **kw),
        "position": torch.rand(shape + (2,), **kw),
        "colour": torch.rand(shape + (c,), **kw),
    }


def synthesize_scenes(digit_bank: torch.Tensor, cfg: DataConfig,
                      space: SpaceConfig, batch: int,
                      generator: Optional[torch.Generator] = None):
    """``(scenes (batch, C, H, W) float32, nums (batch,) int32)``.

    The background is three flat colours: the wall left of the split
    column, the wall right of it, and the floor from the horizon's row
    down.  A scene holds ``k ~ Uniform{min_digits .. max_digits}`` digits,
    each at a uniform in-bounds position, of a uniform colour, with its
    intensity as its alpha; slot 0 is the back, and each later slot is
    composited over the scene so far (``x ← x · (1 − a) + a · colour``).
    The random numbers are ``sample_scene_draws``' from ``generator``.
    """
    with span("data.scenes"):
        ch, cw = cfg.canvas_size
        dh, dw = cfg.digit_size
        t_slots = max(cfg.max_digits, 1)
        dev = digit_bank.device
        d = sample_scene_draws(cfg, space, batch, digit_bank.shape[0],
                               generator, dev)
        rows = torch.arange(ch, device=dev)[None, None, :, None]
        cols = torch.arange(cw, device=dev)[None, None, None, :]
        wall = (rows < d["horizon"][:, None, None, None]).to(torch.float32)
        left = (cols < d["split"][:, None, None, None]).to(torch.float32)
        colour = d["background"][..., None, None]             # (B, 3, C, 1, 1)
        imgs = wall * left * colour[:, 0] \
            + wall * (1.0 - left) * colour[:, 1] \
            + (1.0 - wall) * colour[:, 2]                        # (B, C, H, W)
        s = d["scale"]
        sx, sy = s * dw / cw, s * dh / ch
        tx = (2.0 * d["position"][..., 0] - 1.0) * (1.0 - sx)
        ty = (2.0 * d["position"][..., 1] - 1.0) * (1.0 - sy)
        z_where = torch.stack([sx, sy, tx, ty], dim=-1)          # (B, S, 4)
        present = (torch.arange(t_slots, device=dev)[None, :]
                   < d["nums"][:, None]).to(torch.float32)
        alpha = st_paste(digit_bank[d["idx"]], z_where, (ch, cw)) \
            * present[..., None, None]                           # (B, S, H, W)
        for j in range(t_slots):
            a = alpha[:, j, None]
            imgs = imgs * (1.0 - a) + a * d["colour"][:, j, :, None, None]
        return imgs, d["nums"].to(torch.int32)
