"""SPACE in plain PyTorch: parameters, scenes, the forward and ELBO, and a
trainer of its reparameterised step.

Written from the model's description (Lin, Wu, Peri, Sun, Singh, Deng,
Jiang & Ahn, ICLR 2020, arXiv:2001.02407; github.com/zhixuan-lin/SPACE),
in float32 over a parameter dict, every conv and linear at the precision
``precision.Precision`` gives (float32, TF32 off; one step below for the
control), the spatial transformer ``reference.st``'s dense product (an
indexed gather is ``img[src]`` and then the plain gather).

x ∈ [0, 1]^{C×H×W}; a G × G grid of cells; σ the logistic function; every
Gaussian scale ``softplus(raw) + 1e-4``; every conv but a head followed by
GroupNorm (``group_channels`` a group) and CELU.

1. Encoder: ``e = Enc_fg(x)`` (``space.fg_encoder``) at G × G.
2. Lateral context: ``f = conv3x3([e, L(e)])``, L the ``space.lateral``
   3 × 3 convs.
3. Heads: a 1 × 1 conv on f gives per cell the presence logit ℓ, then the
   locs of z_depth (1), z_scale (2), z_shift (2), then their raw scales.
4. Presence, a relaxed Bernoulli in logit space at temperature τ:
   ``y = (ℓ + log u − log(1 − u)) / τ`` (u clipped to [1e-6, 1 − 1e-6]),
   ``z_pres = σ(y)``, ``log q(y) = log τ − τy + ℓ − 2 softplus(ℓ − τy)``,
   ``log p(y)`` the same at ``ℓ_p = logit(ρ)`` (ρ: the configuration's
   ``prior``, annealed linearly); ``KL_pres = log q(y) − log p(y)``.
5. Where, depth and what: z_scale, z_shift, z_depth reparameterised;
   the box ``s = σ(z_scale)`` of the side per axis (x, y) and centre
   ``2 (k + 0.5 + tanh(z_shift)) / G − 1``, k the cell's column and row;
   priors N(μ_s, ``z_scale_std``) (μ_s annealed linearly over
   ``z_scale_anneal``), N(0, 1) for z_shift and z_depth.  The glimpse
   ``g`` of every channel at the box; ``q(z_what) = N`` of the glimpse
   encoder and its 1 × 1 head; prior N(0, I).
6. Decoder: a 1 × 1 conv at 1 × 1, blocks (3 × 3 conv to 4 c_out,
   PixelShuffle(2), GroupNorm, CELU), a 3 × 3 conv and a 1 × 1 head to
   ``o = σ(·)`` (C channels) and ``α = σ(·)``.
7. Render: ``α̂ = z_pres α``; ``(α̂ o, α̂)`` pasted at the inverse box,
   ``P_c`` and ``A_c``; ``γ_c = A_c · importance · σ(−z_depth_c)``;
   ``w = softmax_c γ`` per pixel; ``μ_fg = Σ_c w_c P_c``, ``α_fg = Σ_c w_c
   A_c``.
8. Background masks: ``h = Enc_bg(x)`` (4 × 4 stride-2 convs, a linear);
   ``s_k = LSTM_q([h, z^m_{k−1}], s_{k−1})``, ``q(z^m_k) = N`` of a linear
   on s_k; ``s^p_k = LSTM_p(z^m_{k−1}, s^p_{k−1})``, the prior N of a
   linear on it; ``z^m_0 = 0``.  The LSTMs: gates i, f, g, o, the bias on
   the hidden path only.
9. ``m_k = σ(Dec_m(z^m_k))``; ``π_1 = m_1``, ``π_k = m_k Π_{j<k}(1 − m_j)``,
   ``π_K = Π_{j<K}(1 − m_j)``, in log space.
10. ``q(z^c_k) = N`` of ``Enc_c([x, π_k])`` (Enc_bg's convs on C + 1
    channels and a linear), ``p(z^c_k | z^m_k) = N`` of an MLP (linear,
    CELU, linear), ``μ_k = σ(Dec_c(z^c_k))``.  Dec_m, Dec_c: a 1 × 1 conv
    and blocks as in 6, then a 1 × 1 head.
11. ``log p(x_p) = logsumexp(log α_fg + Σ_ch log N(x | μ_fg, σ_fg²),
    log(1 − α_fg) + logsumexp_k [log π_k + Σ_ch log N(x | μ_k, σ_bg²)])``,
    α_fg clamped to [1e-5, 1 − 1e-5].
12. ``ELBO = Σ_p log p(x_p) − Σ_c [KL_pres + z_pres (KL_where + KL_depth +
    KL_what)] − Σ_k [KL(q(z^m_k) ‖ p(z^m_k | z^m_{<k})) + KL(q(z^c_k) ‖
    p(z^c_k | z^m_k))]``, the Gaussian KLs analytic; ``loss = −mean ELBO``;
    every gradient reparameterised.

Departures from SPACE, as this repository trains it:

- the boundary loss is left out;
- one parameter group trained by the port's RMSProp (the configuration's
  ``train``), not RMSprop for the foreground and Adam for the background;
- the softmax over the cells in 7, and pasting ``α̂ o`` rather than ``o``
  and ``α̂`` apart, are this repository's reading of SPACE's renderer;
- τ is constant; the data are this repository's: coloured UCI digits over
  three flat colours (``synthesize``), not 3D-Room or Atari.

The class switches plant faults for calibration: ``depth`` False drops
``σ(−z_depth)`` from γ; ``stick`` False drops π_K, so that the masks no
longer sum to 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from air_bench.reference import st
from air_bench.reference import train as rtrain
from air_bench.reference.air import normal_kl, normal_log_prob
from air_bench.reference.precision import Precision
from air_bench.yardstick import derived_seed
from air_bench.yardstick.weights import _TRUNC_STD

#: What a step reports: the loss, the log-likelihood and each KL term
#: (batch means), and the gradient's norm before clipping.
READINGS = ("loss", "log_likelihood", "kl_pres", "kl_where", "kl_depth",
            "kl_what", "kl_bg", "grad_norm")
MIN_SCALE, ALPHA_CLAMP, U_CLAMP, GN_EPS = 1e-4, 1e-5, 1e-6, 1e-5


def _conv_norm_shapes(s, prefix, c_in, c_out, kernel):
    s[f"{prefix}.conv.weight"] = (c_out, c_in, kernel, kernel)
    s[f"{prefix}.conv.bias"] = (c_out,)
    s[f"{prefix}.norm.weight"] = (c_out,)
    s[f"{prefix}.norm.bias"] = (c_out,)


def _convs_shapes(s, prefix, c_in, specs):
    for i, (width, kernel, _, _) in enumerate(specs):
        _conv_norm_shapes(s, f"{prefix}.{i}", c_in, width, kernel)
        c_in = width
    return c_in


def _decoder_shapes(s, prefix, z, widths, out, last=None):
    _conv_norm_shapes(s, f"{prefix}.inp", z, widths[0], 1)
    for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        s[f"{prefix}.blocks.{j}.conv.weight"] = (4 * b, a, 3, 3)
        s[f"{prefix}.blocks.{j}.conv.bias"] = (4 * b,)
        s[f"{prefix}.blocks.{j}.norm.weight"] = (b,)
        s[f"{prefix}.blocks.{j}.norm.bias"] = (b,)
    width = widths[-1]
    if last is not None:
        _conv_norm_shapes(s, f"{prefix}.last", width, last, 3)
        width = last
    s[f"{prefix}.head.weight"] = (out, width, 1, 1)
    s[f"{prefix}.head.bias"] = (out,)


def _bg_specs(q):
    return [(w, 4, 2, 1) for w in q["bg_encoder"]]


def param_shapes(cfg: dict) -> dict:
    """Every parameter's name and shape, as the program names them."""
    q = cfg["space"]
    c = q["channels"]
    s = {}
    width = _convs_shapes(s, "fg.enc", c, q["fg_encoder"])
    lat = _convs_shapes(s, "fg.lateral", width,
                        [(w, 3, 1, 1) for w in q["lateral"]])
    _conv_norm_shapes(s, "fg.fuse", width + lat, width, 3)
    s["fg.head.weight"] = (11, width, 1, 1)
    s["fg.head.bias"] = (11,)
    g = _convs_shapes(s, "fg.glimpse_enc", c, q["glimpse_encoder"])
    s["fg.glimpse_head.weight"] = (2 * q["z_what"], g, 1, 1)
    s["fg.glimpse_head.bias"] = (2 * q["z_what"],)
    _decoder_shapes(s, "fg.glimpse_dec", q["z_what"], q["glimpse_decoder"],
                    c + 1, q["glimpse_decoder_out"])
    h, w = cfg["model"]["img_size"]
    n = len(q["bg_encoder"])
    flat = q["bg_encoder"][-1] * (h >> n) * (w >> n)
    _convs_shapes(s, "bg.enc", c, _bg_specs(q))
    s["bg.embed.weight"] = (q["bg_embed"], flat)
    s["bg.embed.bias"] = (q["bg_embed"],)
    hid, zm, zc = q["mask_hidden"], q["z_mask"], q["z_comp"]
    for name, n_in in (("bg.mask_lstm", q["bg_embed"] + zm),
                       ("bg.mask_prior_lstm", zm)):
        s[f"{name}.ih.weight"] = (4 * hid, n_in)
        s[f"{name}.hh.weight"] = (4 * hid, hid)
        s[f"{name}.hh.bias"] = (4 * hid,)
    for name in ("bg.mask_post", "bg.mask_prior"):
        s[f"{name}.weight"] = (2 * zm, hid)
        s[f"{name}.bias"] = (2 * zm,)
    _decoder_shapes(s, "bg.mask_dec", zm, q["bg_decoder"], 1)
    _convs_shapes(s, "bg.comp_enc", c + 1, _bg_specs(q))
    s["bg.comp_embed.weight"] = (2 * zc, flat)
    s["bg.comp_embed.bias"] = (2 * zc,)
    ph = q["comp_prior_hidden"]
    s["bg.comp_prior.0.weight"] = (ph, zm)
    s["bg.comp_prior.0.bias"] = (ph,)
    s["bg.comp_prior.2.weight"] = (2 * zc, ph)
    s["bg.comp_prior.2.bias"] = (2 * zc,)
    _decoder_shapes(s, "bg.comp_dec", zc, q["bg_decoder"], c)
    return s


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` from one generator: every matrix and
    filter from one truncated-normal draw (variance 1/fan_in), then every
    conv's and linear's bias from one uniform draw in ``±1/sqrt(fan_in)``
    (PyTorch's default, so that an all-zero glimpse leaves a GroupNorm
    group some spread); GroupNorm scales 1 and shifts 0."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device).manual_seed(derived_seed(seed, "weights"))
    mats = [s for s in shapes.values() if len(s) >= 2]
    flat = torch.empty(sum(math.prod(s) for s in mats), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) >= 2:
            n = math.prod(shape)
            std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
            params[name] = (flat[at:at + n] * std).reshape(shape)
            at += n
    biases = [n for n, s in shapes.items()
              if len(s) == 1 and ".norm." not in n]
    draw = torch.rand(sum(shapes[n][0] for n in biases), generator=gen,
                      device=device)
    at = 0
    for name in biases:
        w = shapes[name[:-len("bias")] + "weight"]
        bound = 1.0 / math.sqrt(math.prod(w[1:]))
        n = shapes[name][0]
        params[name] = (2.0 * draw[at:at + n] - 1.0) * bound
        at += n
    for name, shape in shapes.items():
        if ".norm." in name:
            params[name] = torch.full(shape, float(name.endswith("weight")),
                                      device=device)
    return {n: params[n] for n in shapes}


def synthesize(bank: torch.Tensor, data: dict, space: dict, batch: int,
               generator: torch.Generator, prec: Precision | None = None):
    """``(scenes (batch, C, H, W), nums (batch,) int32)``.

    Draws in order: the count ``U{min_digits .. max_digits}``, the horizon's
    row and the wall's split column (each uniform over its inclusive
    range), three background colours, then for each of ``max_digits``
    slots a bank digit, a scale, a position (a uniform fraction of the
    in-bounds range per axis) and a colour.  Above the horizon the wall
    left and right of the split, below it the floor, each flat; then each
    present digit, slot 0 at the back, composited over the scene with its
    intensity as alpha: ``x ← x (1 − a) + a · colour``."""
    prec = prec or Precision()
    dev = bank.device
    ch, cw = data["canvas_size"]
    dh, dw = data["digit_size"]
    slots, c = max(data["max_digits"], 1), space["channels"]
    lo, hi = data["scale_range"]
    kw = dict(generator=generator, device=dev)
    nums = torch.randint(data["min_digits"], data["max_digits"] + 1,
                         (batch,), **kw)
    horizon = torch.randint(space["horizon"][0], space["horizon"][1] + 1,
                            (batch,), **kw)
    split = torch.randint(space["wall_split"][0], space["wall_split"][1] + 1,
                          (batch,), **kw)
    background = torch.rand((batch, 3, c), **kw)
    idx = torch.randint(0, bank.shape[0], (batch, slots), **kw)
    scale = lo + (hi - lo) * torch.rand((batch, slots), **kw)
    position = torch.rand((batch, slots, 2), **kw)
    colour = torch.rand((batch, slots, c), **kw)

    rows = torch.arange(ch, device=dev)[None, None, :, None]
    cols = torch.arange(cw, device=dev)[None, None, None, :]
    wall = (rows < horizon[:, None, None, None]).to(torch.float32)
    left = (cols < split[:, None, None, None]).to(torch.float32)
    bgc = background[..., None, None]
    imgs = wall * left * bgc[:, 0] + wall * (1.0 - left) * bgc[:, 1] \
        + (1.0 - wall) * bgc[:, 2]
    sx, sy = scale * dw / cw, scale * dh / ch
    tx = (2.0 * position[..., 0] - 1.0) * (1.0 - sx)
    ty = (2.0 * position[..., 1] - 1.0) * (1.0 - sy)
    zw = torch.stack([sx, sy, tx, ty], dim=-1).reshape(-1, 4)
    present = (torch.arange(slots, device=dev)[None] < nums[:, None]
               ).to(torch.float32)
    alpha = st.paste(bank[idx].reshape(-1, dh, dw), zw, (ch, cw), prec) \
        .reshape(batch, slots, ch, cw) * present[..., None, None]
    for j in range(slots):
        a = alpha[:, j, None]
        imgs = imgs * (1.0 - a) + a * colour[:, j, :, None, None]
    return imgs, nums.to(torch.int32)


def sample_noise(cfg: dict, batch: int, generator: torch.Generator, device):
    """The forward's noise in the program's order: the presence uniforms
    ``(B, G²)``, then eps of z_depth, z_scale, z_shift, z_what ``(B, G²,
    ·)``, z_mask and z_comp ``(B, K, ·)``."""
    q = cfg["space"]
    cells, k = q["grid"] ** 2, q["components"]
    kw = dict(generator=generator, device=device)
    return [torch.rand((batch, cells), **kw),
            torch.randn((batch, cells, 1), **kw),
            torch.randn((batch, cells, 2), **kw),
            torch.randn((batch, cells, 2), **kw),
            torch.randn((batch, cells, q["z_what"]), **kw),
            torch.randn((batch, k, q["z_mask"]), **kw),
            torch.randn((batch, k, q["z_comp"]), **kw)]


def z_scale_mean(space: dict, step: int) -> torch.Tensor:
    """z_scale's prior mean at ``step``, annealed linearly (float32)."""
    start, end = space["z_scale_anneal"]
    frac = torch.clamp((torch.tensor(float(step)) - float(start))
                       / max(float(end) - float(start), 1.0), 0.0, 1.0)
    a, b = space["z_scale_mean"]
    return a + (b - a) * frac


def elbo_loss(elbo: torch.Tensor) -> torch.Tensor:
    """The loss of the scenes' ELBOs: their mean, negated."""
    return -torch.mean(elbo)


def _scale(raw):
    return F.softplus(raw) + MIN_SCALE


def _gaussian(raw):
    loc, raw_scale = raw.chunk(2, dim=-1)
    return loc, _scale(raw_scale)


def _lrb_log_prob(y, logits, tau):
    diff = logits - tau * y
    return math.log(tau) + diff - 2.0 * F.softplus(diff)


class Space:
    """The forward of one configuration over a parameter dict."""

    depth = True
    stick = True

    def __init__(self, cfg: dict, params: dict, prec: Precision | None = None):
        self.cfg, self.q, self.p = cfg, cfg["space"], params
        self.prec = prec or Precision()
        self.group = self.q["group_channels"]

    def conv(self, x, prefix, stride=1, padding=0):
        x, w = self.prec._operands(torch.float32, x, self.p[f"{prefix}.weight"])
        return F.conv2d(x, w, self.p[f"{prefix}.bias"], stride, padding)

    def conv_norm(self, x, prefix, stride, padding, shuffle=False):
        y = self.conv(x, f"{prefix}.conv", stride, padding)
        if shuffle:
            y = F.pixel_shuffle(y, 2)
        weight = self.p[f"{prefix}.norm.weight"]
        y = F.group_norm(y, max(weight.shape[0] // self.group, 1), weight,
                         self.p[f"{prefix}.norm.bias"], GN_EPS)
        return F.celu(y)

    def convs(self, x, prefix, specs):
        for i, (_, _, stride, padding) in enumerate(specs):
            x = self.conv_norm(x, f"{prefix}.{i}", stride, padding)
        return x

    def decoder(self, z, prefix, n_blocks, last=False):
        x = self.conv_norm(z[..., None, None], f"{prefix}.inp", 1, 0)
        for j in range(n_blocks):
            x = self.conv_norm(x, f"{prefix}.blocks.{j}", 1, 1, shuffle=True)
        if last:
            x = self.conv_norm(x, f"{prefix}.last", 1, 1)
        return self.conv(x, f"{prefix}.head")

    def linear(self, x, prefix):
        return self.prec.linear(x, self.p[f"{prefix}.weight"],
                                self.p.get(f"{prefix}.bias"), torch.float32)

    def lstm(self, prefix, state, x):
        c, h = state
        gates = self.prec.linear(x, self.p[f"{prefix}.ih.weight"], None,
                                 torch.float32) \
            + self.linear(h, f"{prefix}.hh")
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def foreground(self, x, rho, mu_s, u, e_depth, e_scale, e_shift, e_what):
        q = self.q
        batch, c, hh, ww = x.shape
        grid = q["grid"]
        e = self.convs(x, "fg.enc", q["fg_encoder"])
        lat = self.convs(e, "fg.lateral", [(w, 3, 1, 1) for w in q["lateral"]])
        f = self.conv_norm(torch.cat([e, lat], 1), "fg.fuse", 1, 1)
        heads = self.conv(f, "fg.head").flatten(2).transpose(1, 2)
        logit = heads[..., 0]
        depth = heads[..., 1:2], _scale(heads[..., 6:7])
        scale = heads[..., 2:4], _scale(heads[..., 7:9])
        shift = heads[..., 4:6], _scale(heads[..., 9:11])
        tau = q["tau"]
        u = torch.clamp(u, U_CLAMP, 1.0 - U_CLAMP)
        y = (logit + torch.log(u) - torch.log1p(-u)) / tau
        kl_pres = _lrb_log_prob(y, logit, tau) - _lrb_log_prob(
            y, torch.log(rho) - torch.log1p(-rho), tau)
        z_pres = torch.sigmoid(y)
        z_depth = depth[0] + depth[1] * e_depth
        z_scale = scale[0] + scale[1] * e_scale
        z_shift = shift[0] + shift[1] * e_shift
        kl_where = torch.sum(normal_kl(*scale, mu_s, q["z_scale_std"])
                             + normal_kl(*shift, 0.0, 1.0), -1)
        kl_depth = normal_kl(*depth, 0.0, 1.0)[..., 0]
        k = torch.arange(grid, dtype=torch.float32, device=x.device)
        offset = torch.stack([k.repeat(grid), k.repeat_interleave(grid)], -1)
        centre = 2.0 * (offset + 0.5 + torch.tanh(z_shift)) / grid - 1.0
        z_where = torch.cat([torch.sigmoid(z_scale), centre], -1)
        cells = grid * grid
        # the indexed gather: every channel's glimpse at its cell's box
        src = (torch.arange(batch, device=x.device)[:, None, None] * c
               + torch.arange(c, device=x.device)).expand(-1, cells, -1)
        imgs = x.reshape(batch * c, hh, ww)[src.reshape(-1)]
        zw = z_where[:, :, None].expand(-1, -1, c, -1).reshape(-1, 4)
        gh, gw = q["glimpse_size"]
        glimpse = st.gather(imgs, zw, (gh, gw), self.prec).reshape(
            batch * cells, c, gh, gw)
        enc = self.convs(glimpse, "fg.glimpse_enc", q["glimpse_encoder"])
        loc, wscale = _gaussian(self.conv(enc, "fg.glimpse_head").flatten(1))
        z_what = loc + wscale * e_what.reshape(loc.shape)
        kl_what = torch.sum(normal_kl(loc, wscale, 0.0, 1.0), -1).reshape(
            batch, cells)
        decoded = torch.sigmoid(self.decoder(
            z_what, "fg.glimpse_dec", len(q["glimpse_decoder"]) - 1, True))
        # the render
        a_hat = z_pres.reshape(-1, 1, 1, 1) * decoded[:, -1:]
        rgba = torch.cat([a_hat * decoded[:, :-1], a_hat], 1)
        rows = rgba.shape[1]
        pasted = st.paste(
            rgba.reshape(-1, gh, gw),
            z_where.reshape(-1, 1, 4).expand(-1, rows, -1).reshape(-1, 4),
            (hh, ww), self.prec).reshape(batch, cells, rows, hh, ww)
        depth = torch.sigmoid(-z_depth[..., 0]) if self.depth \
            else torch.ones_like(z_depth[..., 0])
        gamma = pasted[:, :, -1] * (q["importance"] * depth)[..., None, None]
        w = torch.softmax(gamma, 1)
        fg = torch.sum(w[:, :, None] * pasted, 1)
        terms = dict(kl_pres=torch.sum(kl_pres, -1),
                     kl_where=torch.sum(z_pres * kl_where, -1),
                     kl_depth=torch.sum(z_pres * kl_depth, -1),
                     kl_what=torch.sum(z_pres * kl_what, -1))
        return fg[:, :-1], fg[:, -1], terms

    def background(self, x, e_mask, e_comp):
        q = self.q
        batch, k = x.shape[0], q["components"]
        specs = _bg_specs(q)
        h = self.linear(self.convs(x, "bg.enc", specs).flatten(1), "bg.embed")
        zeros = torch.zeros((batch, q["mask_hidden"]), device=x.device)
        post = prior = (zeros, zeros)
        z_prev = torch.zeros((batch, q["z_mask"]), device=x.device)
        kl, zs = 0.0, []
        for i in range(k):
            post, hq = self.lstm("bg.mask_lstm", post,
                                 torch.cat([h, z_prev], -1))
            loc, scale = _gaussian(self.linear(hq, "bg.mask_post"))
            z = loc + scale * e_mask[:, i]
            prior, hp = self.lstm("bg.mask_prior_lstm", prior, z_prev)
            kl = kl + torch.sum(normal_kl(
                loc, scale, *_gaussian(self.linear(hp, "bg.mask_prior"))), -1)
            zs.append(z)
            z_prev = z
        z_mask = torch.stack(zs, 1)
        n_blocks = len(q["bg_decoder"]) - 1
        logits = self.decoder(z_mask.flatten(0, 1), "bg.mask_dec",
                              n_blocks).reshape((batch, k) + x.shape[-2:])
        log_m, log_rest = F.logsigmoid(logits), F.logsigmoid(-logits)
        scope, log_pi = torch.zeros_like(log_m[:, 0]), []
        for i in range(k - 1):
            log_pi.append(log_m[:, i] + scope)
            scope = scope + log_rest[:, i]
        if not self.stick:
            scope = torch.full_like(scope, -math.inf)
        log_pi = torch.stack(log_pi + [scope], 1)
        inp = torch.cat([x[:, None].expand(-1, k, -1, -1, -1),
                         torch.exp(log_pi)[:, :, None]], 2)
        loc, scale = _gaussian(self.linear(
            self.convs(inp.flatten(0, 1), "bg.comp_enc", specs).flatten(1),
            "bg.comp_embed"))
        z_comp = loc + scale * e_comp.flatten(0, 1)
        hid = F.celu(self.linear(z_mask.flatten(0, 1), "bg.comp_prior.0"))
        p_loc, p_scale = _gaussian(self.linear(hid, "bg.comp_prior.2"))
        kl = kl + torch.sum(normal_kl(loc, scale, p_loc, p_scale),
                            -1).reshape(batch, k).sum(-1)
        mu = torch.sigmoid(self.decoder(z_comp, "bg.comp_dec", n_blocks))
        return log_pi, mu.reshape((batch, k) + x.shape[1:]), kl

    def forward(self, x, rho, mu_s, noise):
        """``x (B, C, H, W)``, ``noise`` as ``sample_noise`` draws it; a
        dict of ``(B,)`` terms."""
        q = self.q
        u, e_depth, e_scale, e_shift, e_what, e_mask, e_comp = noise
        mu_fg, alpha_fg, terms = self.foreground(
            x, rho, mu_s, u, e_depth, e_scale, e_shift, e_what)
        log_pi, mu_bg, kl_bg = self.background(x, e_mask, e_comp)
        alpha_fg = torch.clamp(alpha_fg, ALPHA_CLAMP, 1.0 - ALPHA_CLAMP)
        fg = torch.log(alpha_fg) + torch.sum(
            normal_log_prob(x, mu_fg, q["fg_std"]), 1)
        bg = torch.log1p(-alpha_fg) + torch.logsumexp(
            log_pi + torch.sum(normal_log_prob(x[:, None], mu_bg,
                                               q["bg_std"]), 2), 1)
        log_lik = torch.sum(torch.logsumexp(torch.stack([fg, bg]), 0),
                            (-2, -1))
        elbo = log_lik - terms["kl_pres"] - terms["kl_where"] \
            - terms["kl_depth"] - terms["kl_what"] - kl_bg
        return dict(terms, elbo=elbo, log_likelihood=log_lik, kl_bg=kl_bg)


class Trainer(rtrain.Trainer):
    """``reference.train.Trainer`` on scenes: the step's scenes from its
    data generator (``synthesize``), the noise from its model generator,
    the loss ``elbo_loss`` of the scenes' ELBOs, and the same update."""

    def __init__(self, cfg: dict, params: dict, bank: torch.Tensor,
                 base_seed: int, prec: Precision | None = None):
        super().__init__(cfg, params, bank, base_seed, prec)
        self.readings = READINGS

    def batch(self, step: int):
        dev = self.bank.device
        g_data, g_model = (torch.Generator(dev).manual_seed(s)
                           for s in rtrain.step_seeds(self.base_seed, step))
        imgs, nums = synthesize(self.bank, self.cfg["data"],
                                self.cfg["space"],
                                self.cfg["train"]["batch_size"], g_data,
                                self.prec)
        return imgs, nums, sample_noise(self.cfg, imgs.shape[0], g_model, dev)

    def step(self):
        cfg, s = self.cfg, self.step_no
        dev = self.bank.device
        imgs, _, noise = self.batch(s)
        rho = rtrain.prior_success_prob(cfg["prior"], s).to(dev)
        mu_s = z_scale_mean(cfg["space"], s).to(dev)
        out = Space(cfg, self.params, self.prec).forward(imgs, rho, mu_s,
                                                         noise)
        loss = elbo_loss(out["elbo"])
        terms = {k: torch.mean(out[k].detach()) for k in READINGS
                 if k in out}
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        norm = rtrain.global_norm(grads.values())
        self.update(grads)
        self.step_no += 1
        got = dict(terms, loss=loss.detach(), grad_norm=norm)
        return {k: float(got[k]) for k in self.readings}, grads
