"""The least traffic of the spatial transformer's work, from shapes.

A gather of ``N`` windows from ``(H, W)`` images into ``(h, w)`` outputs
reads every float32 input pixel and the four window numbers once and
writes every output pixel once: ``4 N (H W + 4 + h w)`` bytes.  Its
backward reads the input and the output's cotangent once, reads the
window and writes its gradient (32 bytes a window), and writes the
image's gradient only where autograd asks for it: for a paste (the
decoded glimpse needs it) and not for the attend step's gather (the
image is data).  A paste is a gather from the glimpse into the canvas.

The work is that of the configuration's shapes, whatever implements it.
A train step: one synthesis paste (digit into canvas, ``N = batch *
max_digits``, forward only), then per object step one gather (canvas to
glimpse) and one paste (glimpse to canvas) at ``N = batch``, each forward
and backward, in each forward the objective runs (``iwae_particles``
under ``iwae``).  A served request: per object step one gather and one
paste at ``N = batch``, forward only.
"""

from __future__ import annotations

from air_bench.reference.train import particles


def gather(n: int, in_shape, out_shape) -> int:
    return 4 * n * (in_shape[0] * in_shape[1] + 4
                    + out_shape[0] * out_shape[1])


def gather_bwd(n: int, in_shape, out_shape, need_img: bool) -> int:
    n_in = in_shape[0] * in_shape[1]
    return (4 * n * (n_in + out_shape[0] * out_shape[1]) + 32 * n
            + (4 * n * n_in if need_img else 0))


def train_step(cfg: dict) -> dict:
    """``{"forward": bytes, "backward": bytes}`` of one train step."""
    m, d = cfg["model"], cfg["data"]
    b, t = cfg["train"]["batch_size"], m["max_steps"]
    canvas, glimpse = m["img_size"], m["glimpse_size"]
    k = particles(cfg)
    fwd = gather(b * max(d["max_digits"], 1), d["digit_size"],
                 d["canvas_size"])
    fwd += k * t * (gather(b, canvas, glimpse) + gather(b, glimpse, canvas))
    bwd = k * t * (gather_bwd(b, canvas, glimpse, need_img=False)
                   + gather_bwd(b, glimpse, canvas, need_img=True))
    return {"forward": fwd, "backward": bwd}


def request(cfg: dict, batch: int) -> int:
    """Bytes of one served request of ``batch`` images."""
    m = cfg["model"]
    canvas, glimpse = m["img_size"], m["glimpse_size"]
    return m["max_steps"] * (gather(batch, canvas, glimpse)
                             + gather(batch, glimpse, canvas))
