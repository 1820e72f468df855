"""Model FLOPs and spatial-transformer bytes of a SQAIR train step,
counted from the configuration by the rules of ``flops`` and
``st_bytes``.

FLOPs: every linear a forward runs on one sequence, with its widths, the
rows it sees (one a slot and frame) and its stated precision: in each of
the T frames, discovery's are AIR's (``flops.linears``, no baseline); each
of the N slots runs propagation's (the proposal encoder, the temporal and
relation LSTMs, the where, what and presence networks, the decoder) and
its prior's (an LSTM, two Gaussian heads, the presence logit).  LSTMs
and presence logits are float32, the decoder ``decoder_dtype``, the rest
``dtype``.  A train step counts each forward once and its backward twice
that, for each of the ``iwae_particles`` forwards.

Bytes: one synthesis paste (digit into frame) for every digit of every
frame of the batch, forward only; then, in each particle's forward, per
frame and slot three gathers (propagation's proposal and glimpse,
discovery's glimpse, frame into glimpse) and two pastes (glimpse into
frame), each with its backward, but the first frame's proposal gathers,
whose window (the zero state) and image (data) need no gradient.
"""

from __future__ import annotations

from air_bench.reference.train import particles
from air_bench.yardstick import flops
from air_bench.yardstick.st_bytes import gather, gather_bwd


def linears(cfg: dict) -> list:
    """``(name, in, out, rows per sequence, stated dtype)`` of every
    linear of one forward."""
    m, q = cfg["model"], cfg["sequence"]
    frames, n = q["frames"], m["max_steps"]
    d = m["dtype"] or "float32"
    dec = m["decoder_dtype"] or d
    gh, gw = m["glimpse_size"]
    n_g, n_what = gh * gw, m["n_what"]
    d_where = 3 if m["isotropic_scale"] else 4
    ht, hr, hp = q["temporal_hidden"], q["relation_hidden"], q["prior_hidden"]
    rows = frames * n

    def last(n_in, hidden):
        return hidden[-1] if hidden else n_in

    out = [(f"disc.{name}", a, b, r * frames, dt)
           for name, a, b, r, dt in flops.linears(cfg, False)]
    out += flops._mlp("prop.proposal", n_g, q["proposal_hidden"], rows, d)
    enc = last(n_g, q["proposal_hidden"])
    out += [("prop.temporal.ih", enc + n_what + 4, 4 * ht, rows, "float32"),
            ("prop.temporal.hh", ht, 4 * ht, rows, "float32"),
            ("prop.relation.ih", ht + n_what + 5, 4 * hr, rows, "float32"),
            ("prop.relation.hh", hr, 4 * hr, rows, "float32")]
    out += flops._mlp("prop.where", ht + hr, m["transform_hidden"], rows, d)
    tw = last(ht + hr, m["transform_hidden"])
    out += [(f"prop.where.{k}", tw, d_where, rows, d)
            for k in ("loc", "scale")]
    out += flops._mlp("prop.what", n_g, m["glimpse_encoder_hidden"], rows, d)
    ww = last(n_g, m["glimpse_encoder_hidden"]) + ht + hr
    out += [(f"prop.what.{k}", ww, n_what, rows, d) for k in ("loc", "scale")]
    pres_in = ht + hr + 4 + n_what
    out += flops._mlp("prop.pres", pres_in, m["steps_hidden"], rows, d)
    out += [("prop.pres.logit", last(pres_in, m["steps_hidden"]), 1, rows,
             "float32")]
    out += flops._mlp("prop.decoder", n_what, m["decoder_hidden"], rows, dec,
                      n_g)
    out += [("prior.lstm.ih", n_what + 4, 4 * hp, rows, "float32"),
            ("prior.lstm.hh", hp, 4 * hp, rows, "float32")]
    out += [(f"prior.where.{k}", hp, d_where, rows, d)
            for k in ("loc", "scale")]
    out += [(f"prior.what.{k}", hp, n_what, rows, d)
            for k in ("loc", "scale")]
    out += [("prior.pres", hp, 1, rows, "float32")]
    return out


def per_sequence(cfg: dict) -> dict:
    """FLOPs of one sequence's part of a train step, by stated dtype."""
    mult = 3 * particles(cfg)
    by = {}
    for _, a, b, rows, dtype in linears(cfg):
        by[dtype] = by.get(dtype, 0) + mult * 2 * a * b * rows
    return by


def least_seconds(cfg: dict, peaks: dict) -> float:
    """The least time of one sequence's model FLOPs in a train step, each
    at its dtype's peak."""
    return sum(f / peaks[dtype] for dtype, f in per_sequence(cfg).items())


def train_step(cfg: dict) -> dict:
    """``{"forward": bytes, "backward": bytes}`` of one train step's
    spatial-transformer work."""
    m, d, q = cfg["model"], cfg["data"], cfg["sequence"]
    b, n, frames = cfg["train"]["batch_size"], m["max_steps"], q["frames"]
    canvas, glimpse = m["img_size"], m["glimpse_size"]
    k = particles(cfg)
    pairs = frames * n
    fwd = gather(b * max(d["max_digits"], 1) * frames, d["digit_size"],
                 d["canvas_size"])
    fwd += k * pairs * (3 * gather(b, canvas, glimpse)
                        + 2 * gather(b, glimpse, canvas))
    bwd = k * ((3 * pairs - n) * gather_bwd(b, canvas, glimpse, False)
               + 2 * pairs * gather_bwd(b, glimpse, canvas, True))
    return {"forward": fwd, "backward": bwd}
