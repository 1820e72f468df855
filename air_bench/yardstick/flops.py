"""Model FLOPs of AIR, counted from the configuration.

Every linear layer the model runs, with its input and output widths, the
rows it sees per image and the precision the configuration states for it:
``dtype`` for the encoder, the window and appearance networks, the
presence MLP and the NVIL baseline; ``decoder_dtype`` (else ``dtype``) for
the decoder; float32 for the LSTM and the presence logit.  A row costs
``2 * in * out``; a train step counts each linear's forward once and its
backward twice that (remat's recompute is not counted), for each forward
the objective runs: ``iwae_particles`` under ``iwae``, one under ``elbo``.
The spatial transformer's products are not model FLOPs (``st_bytes``
counts its work).  The least time of the work runs each product at the
peak of its precision (``peaks``).
"""

from __future__ import annotations

from air_bench.reference.train import particles


def _mlp(name, n_in, hidden, rows, dtype, out=None):
    widths = [n_in, *hidden] + ([out] if out is not None else [])
    return [(f"{name}.{i}", a, b, rows, dtype)
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]


def linears(cfg: dict, with_baseline: bool) -> list:
    """``(name, in, out, rows per image, stated dtype)`` of every linear of
    one forward."""
    m = cfg["model"]
    t = m["max_steps"]
    d = m["dtype"] or "float32"
    dec = m["decoder_dtype"] or d
    gh, gw = m["glimpse_size"]
    h_img, w_img = m["img_size"]
    n_what, hid = m["n_what"], m["rnn_hidden"]
    d_where = 3 if m["isotropic_scale"] else 4
    n_img = h_img * w_img
    enc = m["encoder_hidden"][-1] if m["encoder_hidden"] else n_img
    tw = m["transform_hidden"][-1] if m["transform_hidden"] else hid
    ww = (m["glimpse_encoder_hidden"][-1] if m["glimpse_encoder_hidden"]
          else gh * gw)
    steps_in = hid + 4 + 2 * n_what
    sw = m["steps_hidden"][-1] if m["steps_hidden"] else steps_in
    out = []
    out += _mlp("encoder", n_img, m["encoder_hidden"], t, d)
    out += [("lstm.ih", enc + n_what + 4 + 1, 4 * hid, t, "float32"),
            ("lstm.hh", hid, 4 * hid, t, "float32")]
    out += _mlp("where", hid, m["transform_hidden"], t, d)
    out += [("where.loc", tw, d_where, t, d), ("where.scale", tw, d_where, t, d)]
    out += _mlp("what", gh * gw, m["glimpse_encoder_hidden"], t, d)
    out += [("what.loc", ww, n_what, t, d), ("what.scale", ww, n_what, t, d)]
    out += _mlp("steps", steps_in, m["steps_hidden"], t, d)
    out += [("steps.logit", sw, 1, t, "float32")]
    out += _mlp("decoder", n_what, m["decoder_hidden"], t, dec, gh * gw)
    if with_baseline:
        feats = 2 * d_where + 4 + n_what + 2 + t
        widths = [*m["baseline_hidden"], 1]
        out += [("baseline.0.image", n_img, widths[0], 1, d),
                ("baseline.0.steps", feats, widths[0], t, d)]
        out += [(f"baseline.{i + 1}", a, b, t, d)
                for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
    return out


def per_image(cfg: dict, train: bool, with_baseline: bool) -> dict:
    """FLOPs per image by stated dtype: a forward, or a train step's
    forwards and backwards."""
    mult = 3 * particles(cfg) if train else 1
    by = {}
    for _, a, b, rows, dtype in linears(cfg, with_baseline):
        by[dtype] = by.get(dtype, 0) + mult * 2 * a * b * rows
    return by


def least_seconds(cfg: dict, train: bool, with_baseline: bool,
                  peaks: dict) -> float:
    """The least time of one image's model FLOPs, each at its dtype's
    peak."""
    return sum(f / peaks[dtype] for dtype, f in
               per_image(cfg, train, with_baseline).items())
