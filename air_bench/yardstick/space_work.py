"""Model FLOPs and spatial-transformer bytes of a SPACE train step,
counted from the configuration by the rules of ``flops`` and ``st_bytes``.

FLOPs: every conv and linear a forward runs on one scene, all float32.
A conv of ``C_in → C_out`` with a ``k × k`` kernel costs ``2 C_in k² C_out``
an output pixel, a linear ``2 in out`` a row.  Per scene: the image
encoder, the lateral convs, their join and the heads at the grid; per
cell (G² of them) the glimpse encoder and its head on a C-channel glimpse
and the glimpse decoder; the background encoder and its linear; K steps
of the two LSTM chains and their linears; K mask decodes, K component
encodes and their linear, K component priors and K component decodes.
A train step counts each forward once and its backward twice that.

Bytes: one synthesis paste (digit into scene) for every digit slot of
every scene, forward only; per scene G²·C indexed gathers (scene into
glimpse) with their backward, window gradient only (``indexed``: the
function needs each of the B·C images once, however many windows read
it), and G²·(C + 1) pastes (glimpse into scene) with their backward,
both gradients.
"""

from __future__ import annotations

from air_bench.yardstick.st_bytes import gather, gather_bwd


def _conv(name, c_in, c_out, kernel, side_out):
    """``(name, FLOPs)`` of one conv at an output side ``side_out``."""
    return name, 2 * c_in * kernel * kernel * c_out * side_out * side_out


def _out_side(side, kernel, stride, padding):
    return (side + 2 * padding - kernel) // stride + 1


def _convs(name, c_in, specs, side):
    out = []
    for i, (width, kernel, stride, padding) in enumerate(specs):
        side = _out_side(side, kernel, stride, padding)
        out.append(_conv(f"{name}.{i}", c_in, width, kernel, side))
        c_in = width
    return out, c_in, side


def _decoder(name, z, widths, out_channels, last=None):
    ops = [_conv(f"{name}.inp", z, widths[0], 1, 1)]
    side = 1
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        ops.append(_conv(f"{name}.blocks.{j}", a, 4 * b, 3, side))
        side *= 2
    width = widths[-1]
    if last is not None:
        ops.append(_conv(f"{name}.last", width, last, 3, side))
        width = last
    ops.append(_conv(f"{name}.head", width, out_channels, 1, side))
    return ops


def layers(cfg: dict) -> list:
    """``(name, FLOPs)`` of every conv and linear of one scene's forward,
    each with the times it runs folded in."""
    q = cfg["space"]
    c, side = q["channels"], cfg["model"]["img_size"][0]
    cells, k = q["grid"] ** 2, q["components"]
    out, width, fside = _convs("fg.enc", c, q["fg_encoder"], side)
    lat, lw, _ = _convs("fg.lateral", width,
                        [(w, 3, 1, 1) for w in q["lateral"]], fside)
    out += lat
    out.append(_conv("fg.fuse", width + lw, width, 3, fside))
    out.append(_conv("fg.head", width, 11, 1, fside))
    per_cell, g, gside = _convs("fg.glimpse_enc", c, q["glimpse_encoder"],
                                q["glimpse_size"][0])
    per_cell.append(_conv("fg.glimpse_head", g, 2 * q["z_what"], 1, gside))
    per_cell += _decoder("fg.glimpse_dec", q["z_what"], q["glimpse_decoder"],
                         c + 1, q["glimpse_decoder_out"])
    out += [(n, f * cells) for n, f in per_cell]
    specs = [(w, 4, 2, 1) for w in q["bg_encoder"]]
    bg, bw, bside = _convs("bg.enc", c, specs, side)
    out += bg
    flat = bw * bside * bside
    hid, zm, zc = q["mask_hidden"], q["z_mask"], q["z_comp"]
    out.append(("bg.embed", 2 * flat * q["bg_embed"]))
    per_k = [("bg.mask_lstm", 2 * (q["bg_embed"] + zm + hid) * 4 * hid),
             ("bg.mask_prior_lstm", 2 * (zm + hid) * 4 * hid),
             ("bg.mask_post", 2 * hid * 2 * zm),
             ("bg.mask_prior", 2 * hid * 2 * zm),
             ("bg.comp_embed", 2 * flat * 2 * zc),
             ("bg.comp_prior", 2 * (zm + 2 * zc) * q["comp_prior_hidden"])]
    per_k += _decoder("bg.mask_dec", zm, q["bg_decoder"], 1)
    per_k += _convs("bg.comp_enc", c + 1, specs, side)[0]
    per_k += _decoder("bg.comp_dec", zc, q["bg_decoder"], c)
    out += [(n, f * k) for n, f in per_k]
    return out


def per_scene(cfg: dict) -> int:
    """FLOPs of one scene's part of a train step (float32)."""
    return 3 * sum(f for _, f in layers(cfg))


def least_seconds(cfg: dict, peaks: dict) -> float:
    """The least time of one scene's model FLOPs in a train step, at the
    float32 peak."""
    return per_scene(cfg) / peaks["float32"]


def indexed(images: int, n: int, in_shape, out_shape,
            backward: bool) -> int:
    """Bytes of an indexed gather of ``n`` windows from ``images`` float32
    images, or of its window-gradient backward: every image read once,
    each window's four numbers and int32 index read, and the output
    written (the backward: the cotangent read and the window's gradient
    written)."""
    n_in, n_out = in_shape[0] * in_shape[1], out_shape[0] * out_shape[1]
    return 4 * (images * n_in + n * (4 + 1 + n_out)
                + (4 * n if backward else 0))


def train_step(cfg: dict) -> dict:
    """``{"forward": bytes, "backward": bytes}`` of one train step's
    spatial-transformer work."""
    q, d = cfg["space"], cfg["data"]
    b, c = cfg["train"]["batch_size"], q["channels"]
    scene, glimpse = cfg["model"]["img_size"], q["glimpse_size"]
    windows, pastes = b * q["grid"] ** 2 * c, b * q["grid"] ** 2 * (c + 1)
    fwd = gather(b * max(d["max_digits"], 1), d["digit_size"],
                 d["canvas_size"])
    fwd += indexed(b * c, windows, scene, glimpse, False) \
        + gather(pastes, glimpse, scene)
    bwd = indexed(b * c, windows, scene, glimpse, True) \
        + gather_bwd(pastes, glimpse, scene, True)
    return {"forward": fwd, "backward": bwd}
