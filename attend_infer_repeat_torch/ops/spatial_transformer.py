"""Spatial transformer: bilinear glimpse gather and its inverse (paste).

AIR's affine warps are axis-aligned ``(sx, sy, tx, ty)``, so bilinear
resampling is separable: ``glimpse = W_y · image · W_xᵀ`` with per-example
weight matrices whose rows hold at most two nonzero hat weights.

Conventions:

- ``z_where = (sx, sy, tx, ty)``.
- Pixel centers of an ``n``-pixel axis sit at ``linspace(-1, 1, n)``
  (align-corners).
- Gather (attend): glimpse pixel at normalized coord ``u`` samples the
  image at ``x = sx·u + tx``.
- Paste (decode): canvas pixel at ``x`` samples the glimpse at
  ``u = (x − tx)/sx``, i.e. a gather under the inverted affine.
- Out-of-bounds samples contribute zero.

``st_gather`` dispatches by device, forward and backward: a CUDA tensor
goes to the hand-written kernels (``st_kernel.st_gather_cuda`` and
``st_gather_bwd_cuda``), a CPU tensor to their plain versions, the
separable einsum and its explicit VJP.  ``st_paste_accumulate`` (the
cell's canvas update) dispatches the same way, its forward fused with
the update on the card.
"""

from __future__ import annotations

import torch


def invert_where(z_where: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Invert an axis-aligned affine ``(sx, sy, tx, ty)``.

    ``x = s·u + t  ⇔  u = x/s − t/s``.  Scales are pushed away from zero
    by a sign-preserving ``eps``, so a near-zero scale gives a huge, fully
    out-of-bounds inverse (an all-zero paste) instead of NaNs.
    """
    sx, sy, tx, ty = torch.split(z_where, 1, dim=-1)
    sx = _away_from_zero(sx, eps)
    sy = _away_from_zero(sy, eps)
    return torch.cat([1.0 / sx, 1.0 / sy, -tx / sx, -ty / sy], dim=-1)


def _away_from_zero(s: torch.Tensor, eps: float) -> torch.Tensor:
    """Push values in ``(-eps, eps)`` to ``±eps`` (0 maps to ``+eps``)."""
    tiny = torch.where(s < 0.0, -eps, eps).to(s.dtype)
    return torch.where(torch.abs(s) < eps, tiny, s)


def _source_coords(scale, shift, out_size: int):
    """``u (out,)`` and the source coordinates ``p (..., out)`` of one axis.

    Output pixel ``i`` samples input coordinate
    ``p_i = ((scale·u_i + shift) + 1)·(in−1)/2`` (``in`` applied by the
    caller); ``u_i = 2i/(out−1) − 1`` is computed as the kernels compute it.
    """
    k = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    # divide by a tensor: PyTorch multiplies by the reciprocal of a scalar
    # divisor, which rounds differently from the kernel's division
    u = 2.0 * k / torch.full_like(k, max(out_size - 1, 1)) - 1.0
    return u, scale[..., None] * u + shift[..., None]        # (..., out)


def _axis_weights(scale, shift, out_size: int, in_size: int) -> torch.Tensor:
    """Bilinear interpolation weights for one axis: ``(..., out, in)``.

    Tap ``q`` receives the hat weight ``relu(1 − |p_i − q|)``, which is
    zero padding by construction.
    """
    _, src = _source_coords(scale, shift, out_size)
    p = (src + 1.0) * (in_size - 1) / 2.0
    q = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    return torch.relu(1.0 - torch.abs(p[..., :, None] - q))   # (..., out, in)


def _axis_weights_and_dp(scale, shift, out_size: int, in_size: int):
    """Hat weights, their derivative w.r.t. ``p``, and ``u``.

    ``w = relu(1 − |p − q|)`` as in ``_axis_weights``;
    ``dw/dp = −sign(p − q)·1[|p − q| < 1]``, the a.e. derivative; ``u``
    ``(out,)``, since ``dp/dscale = u·(in−1)/2`` and
    ``dp/dshift = (in−1)/2``.
    """
    u, src = _source_coords(scale, shift, out_size)
    p = (src + 1.0) * (in_size - 1) / 2.0
    q = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    d = p[..., :, None] - q                                    # (..., out, in)
    w = torch.relu(1.0 - torch.abs(d))
    dw_dp = torch.where(torch.abs(d) < 1.0, -torch.sign(d),
                        torch.zeros_like(d))
    return w, dw_dp, u


def st_weights(z_where: torch.Tensor, out_shape, in_shape):
    """Separable weight matrices ``(W_y (..., out_h, in_h), W_x (..., out_w, in_w))``."""
    out_h, out_w = out_shape
    in_h, in_w = in_shape
    sx, sy, tx, ty = (z_where[..., i] for i in range(4))
    return (_axis_weights(sy, ty, out_h, in_h),
            _axis_weights(sx, tx, out_w, in_w))


def st_gather(image: torch.Tensor, z_where: torch.Tensor,
              glimpse_shape) -> torch.Tensor:
    """Extract a bilinear glimpse (attend), in float32.

    ``image (..., H, W)``, ``z_where (..., 4)`` → ``(..., h, w)``.  The model
    runs the spatial transformer on f32 operands in every dtype mix, as
    the JAX package's default ``st_method="xla"`` does.  Differentiable in
    both arguments through ``st_kernel.STGather``.
    """
    from attend_infer_repeat_torch.ops import st_kernel

    batch_shape = image.shape[:-2]
    img = image.reshape((-1,) + tuple(image.shape[-2:])).to(torch.float32)
    zw = z_where.reshape(-1, 4).to(torch.float32)
    glimpse_shape = tuple(glimpse_shape)
    out = st_kernel.STGather.apply(img.contiguous(), zw.contiguous(),
                                   glimpse_shape)
    return out.reshape(tuple(batch_shape) + glimpse_shape)


def st_paste(glimpse: torch.Tensor, z_where: torch.Tensor,
             canvas_shape) -> torch.Tensor:
    """Paste a glimpse onto a canvas (decode): a gather under the inverse.

    ``glimpse (..., h, w)``, ``z_where (..., 4)`` → ``(..., H, W)``.
    """
    return st_gather(glimpse, invert_where(z_where), canvas_shape)


def st_paste_accumulate(canvas: torch.Tensor, glimpse: torch.Tensor,
                        z_where: torch.Tensor,
                        z_pres: torch.Tensor) -> torch.Tensor:
    """Paste a glimpse into a carried canvas, masked by presence.

    ``canvas (..., H, W)`` (float32 or bfloat16), ``glimpse (..., h, w)``,
    ``z_where (..., 4)``, ``z_pres (..., 1)`` → the new canvas, at the
    canvas's dtype: ``f32(canvas) + z_pres · st_paste(glimpse, z_where)``
    accumulated in f32 and cast back.  One fused kernel on the card
    (``st_kernel.STGatherAccumulate``), the same bits as those ops;
    differentiable in the canvas, the glimpse and ``z_where``.
    """
    from attend_infer_repeat_torch.ops import st_kernel

    shape = canvas.shape
    flat = canvas.reshape((-1,) + tuple(shape[-2:]))
    img = glimpse.reshape((-1,) + tuple(glimpse.shape[-2:])).to(torch.float32)
    zw = invert_where(z_where).reshape(-1, 4).to(torch.float32)
    pres = z_pres.reshape(-1).to(torch.float32)
    out = st_kernel.STGatherAccumulate.apply(
        flat.contiguous(), img.contiguous(), zw.contiguous(),
        pres.contiguous())
    return out.reshape(shape)


def st_gather_reference(image: torch.Tensor, z_where: torch.Tensor,
                        glimpse_shape) -> torch.Tensor:
    """Direct 4-tap bilinear gather: a parity oracle for tests only."""
    batch_shape = image.shape[:-2]
    in_h, in_w = image.shape[-2:]
    out_h, out_w = glimpse_shape
    img = image.reshape(-1, in_h, in_w)
    zw = z_where.reshape(-1, 4)
    n = img.shape[0]
    sx, sy, tx, ty = (zw[:, i:i + 1] for i in range(4))
    u = torch.linspace(-1.0, 1.0, out_w, device=img.device)
    v = torch.linspace(-1.0, 1.0, out_h, device=img.device)
    xs = (sx * u + tx + 1.0) * (in_w - 1) / 2.0          # (N, out_w)
    ys = (sy * v + ty + 1.0) * (in_h - 1) / 2.0          # (N, out_h)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx1, wy1 = xs - x0, ys - y0
    bidx = torch.arange(n, device=img.device)[:, None, None]

    def tap(yi, xi):
        inb = (((yi >= 0) & (yi < in_h))[:, :, None]
               & ((xi >= 0) & (xi < in_w))[:, None, :])
        yc = torch.clamp(yi, 0, in_h - 1).long()
        xc = torch.clamp(xi, 0, in_w - 1).long()
        vals = img[bidx, yc[:, :, None], xc[:, None, :]]
        return torch.where(inb, vals, torch.zeros_like(vals))

    g = ((1 - wy1)[:, :, None] * (1 - wx1)[:, None, :] * tap(y0, x0)
         + (1 - wy1)[:, :, None] * wx1[:, None, :] * tap(y0, x0 + 1)
         + wy1[:, :, None] * (1 - wx1)[:, None, :] * tap(y0 + 1, x0)
         + wy1[:, :, None] * wx1[:, None, :] * tap(y0 + 1, x0 + 1))
    return g.reshape(tuple(batch_shape) + tuple(glimpse_shape))
