"""The spatial transformer as the plain separable product.

``z_where = (sx, sy, tx, ty)``.  Output pixel ``i`` of an ``n``-pixel axis
sits at ``u_i = 2i/(n-1) - 1`` and samples the input at ``s*u_i + t``
(align-corners coordinates in [-1, 1]); tap ``q`` of the input gets the
hat weight ``relu(1 - |p - q|)`` with ``p`` that coordinate in pixels, so
samples outside the input read zero.  ``glimpse = W_y @ image @ W_x^T``;
autograd gives both gradients.  A paste is a gather under the inverse
window.
"""

from __future__ import annotations

import torch

from air_bench.reference.precision import Precision


def _hat(scale, shift, out_n: int, in_n: int) -> torch.Tensor:
    """``(N, out_n, in_n)`` bilinear weights of one axis."""
    k = torch.arange(out_n, dtype=torch.float32, device=scale.device)
    u = 2.0 * k / torch.full_like(k, max(out_n - 1, 1)) - 1.0
    p = (scale[:, None] * u + shift[:, None] + 1.0) * (in_n - 1) / 2.0
    q = torch.arange(in_n, dtype=torch.float32, device=scale.device)
    return torch.relu(1.0 - torch.abs(p[:, :, None] - q))


def gather(img: torch.Tensor, zw: torch.Tensor, out_shape,
           prec: Precision) -> torch.Tensor:
    """``img (N, H, W)``, ``zw (N, 4)`` -> ``(N, h, w)``, in float32."""
    img = img.to(torch.float32)
    zw = zw.to(torch.float32)
    out_h, out_w = out_shape
    in_h, in_w = img.shape[-2:]
    w_y = _hat(zw[:, 1], zw[:, 3], out_h, in_h)
    w_x = _hat(zw[:, 0], zw[:, 2], out_w, in_w)
    return prec.mm(prec.mm(w_y, img), w_x.transpose(-1, -2))


def invert(zw: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The inverse window; scales within ``eps`` of 0 are pushed to
    ``+-eps``, so a vanishing window pastes nothing."""
    sx, sy, tx, ty = torch.split(zw, 1, dim=-1)

    def away(s):
        tiny = torch.where(s < 0.0, -eps, eps).to(s.dtype)
        return torch.where(torch.abs(s) < eps, tiny, s)

    sx, sy = away(sx), away(sy)
    return torch.cat([1.0 / sx, 1.0 / sy, -tx / sx, -ty / sy], dim=-1)


def paste(glimpse: torch.Tensor, zw: torch.Tensor, canvas_shape,
          prec: Precision) -> torch.Tensor:
    """``glimpse (N, h, w)`` pasted into ``(N, H, W)`` at ``zw``."""
    return gather(glimpse, invert(zw), canvas_shape, prec)
