"""Sequential AIR (SQAIR) in plain PyTorch: parameters, moving-digit
sequences, the forward and log weight, and a trainer of the VIMCO step.

Written from the model's description (Kosiorek, Kim, Teh & Posner 2018,
arXiv:1806.01794; github.com/akosiorek/sqair) in the form this repository
trains it, on AIR's networks (``reference.air``).  A sequence has T frames
x_1 … x_T and N object slots (``model.max_steps``); an object is z =
(z_where: 3 numbers, isotropic; z_what; z_pres ∈ {0, 1}).  Slot i carries
across frames its object z_{t-1,i}, a temporal LSTM state and a prior LSTM
state.  For each frame t (all slots absent before frame 1, so that frame
1 is AIR):

1. Propagation, over the slots i = 1 … N in order:
   - proposal glimpse g~ = gather(x_t) at z_where_{t-1,i} with its scale
     times ρ (``sequence.proposal_scale``), encoded by an MLP;
   - h^T_{t,i} = LSTM^T([enc(g~), z_what_{t-1,i}, z_where_{t-1,i}],
     h^T_{t-1,i});
   - h^R_{t,i} = LSTM^R([h^T_{t,i}, z_{t,i-1}], h^R_{t,i-1}), zero state
     and z_{t,0} = 0 at i = 1;
   - q(z_where_{t,i}) = N(z_where_{t-1,i} + μ, σ), (μ, σ) = an MLP and a
     Gaussian head of [h^T, h^R]; sampled by reparameterisation;
   - g = gather(x_t) at z_where_{t,i}; q(z_what_{t,i}) = N(z_what_{t-1,i}
     + μ, σ), (μ, σ) = a Gaussian head of [MLP(g), h^T, h^R];
   - z_pres_{t,i} ~ Bernoulli(p · z_pres_{t-1,i}), p = AIR's presence MLP
     of [h^T, h^R, z_where, z_what] (its explore floor too);
   - the decoded z_what pasted into the frame's canvas, masked by
     presence (AIR's decoder);
   - the prior: h^P_{t,i} = LSTM^P([z_what_{t-1,i}, z_where_{t-1,i}],
     h^P_{t-1,i}); p(z_where), p(z_what) = N(previous value + μ_P, σ_P)
     from Gaussian heads of h^P; p(z_pres = 1) = sigmoid(f(h^P)) ·
     z_pres_{t-1,i}, f one float32 linear;
   - every term of the slot masked by z_pres_{t-1,i}.
2. Discovery: AIR's step (``reference.air.Model.step``) N times on x_t,
   its canvas starting at the propagated render, its carried presence
   masked before step j by the free slots 1[n^P_t + j <= N] (n^P_t the
   propagated objects present); AIR's where prior, N(0, I) for z_what and
   a geometric count prior truncated to the N - n^P_t free slots.
3. Compaction: the frame's slots become the present propagated objects,
   then the present discovered ones, each in its order (here a stable
   sort of the 2N candidates by absence); absent slots are zero; a
   discovered object's temporal and prior states start at zero.

A particle's log weight is Σ_t [log N(x_t | canvas_t, output_std²) + Σ_i
z_pres_{t-1,i} (log p_P − log q of z_where, β × that of z_what, and of
z_pres) + Σ_j pres_j (AIR's where ratio + β × its what ratio) + log p(n_D)
− log q(n_D | x_t)], β the warm-up's ``kl_beta``; the loss is VIMCO's
(``reference.air.vimco_loss``) over the particles, scoring every presence
sample of both phases (each masked by its previous presence).

Departures from the paper, as this repository trains it:

- discovery is conditioned on the propagated objects only through its
  residual (the frame less the propagated render) and the slot mask; the
  paper also feeds it the propagated latents;
- the proposal glimpse is taken at the previous window scaled by ρ, with
  no separate proposal network; the propagation prior is an LSTM over
  the previous latents alone;
- only presence is scored by VIMCO: windows and appearances are
  reparameterised (as ``reference.air``);
- a presence probability is clipped to [1e-7, 1 - 1e-7] inside its
  log-probability, and count probabilities are floored at 1e-20, as in
  ``reference.air``;
- the data are this repository's: UCI digits at 16x16 moving in 50x50
  frames (``synthesize``), not moving MNIST.

Each product runs at the precision the configuration states
(``precision.Precision``); the spatial transformer is ``reference.st``.
"""

from __future__ import annotations

import math

import torch

from air_bench.reference import st
from air_bench.reference import train as rtrain
from air_bench.reference.air import (Model, clip_preserve, normal_log_prob,
                                     param_shapes as air_shapes,
                                     presence_pmf, vimco_loss, where_indices,
                                     _mlp_shapes, _last)
from air_bench.reference.precision import Precision
from air_bench.yardstick import derived_seed
from air_bench.yardstick.weights import _TRUNC_STD

#: What a step reports: the VIMCO loss and the bound (batch means), the
#: log-likelihood and each phase's KL estimate (means over particles and
#: batch), the gradient's norm, and the mean |log weight|, the scale of
#: the loss and the bound.
READINGS = ("loss", "iwae_bound", "log_likelihood", "kl_prop", "kl_disc",
            "grad_norm", "log_w_abs")
#: The presence logits, which start at ``steps_bias``.
PRESENCE_BIASES = ("cell.steps.logit.bias", "prop.pres.logit.bias",
                   "prior.pres.bias")
_EPS = 1e-15


def param_shapes(cfg: dict) -> dict:
    """Every parameter's name and shape: AIR's (no baseline), then the
    propagation core's and its prior's."""
    m, q = cfg["model"], cfg["sequence"]
    gh, gw = m["glimpse_size"]
    n_g, n_what = gh * gw, m["n_what"]
    d_where = len(where_indices(m))
    ht, hr, hp = q["temporal_hidden"], q["relation_hidden"], q["prior_hidden"]
    s = air_shapes(m, False)
    s.update(_mlp_shapes("prop.proposal", n_g, q["proposal_hidden"]))

    def lstm(prefix, n_in, hid):
        s[f"{prefix}.ih.weight"] = (4 * hid, n_in)
        s[f"{prefix}.hh.weight"] = (4 * hid, hid)
        s[f"{prefix}.hh.bias"] = (4 * hid,)

    def head(prefix, n_in, n_out):
        for k in ("loc", "scale"):
            s[f"{prefix}.{k}.weight"] = (n_out, n_in)
            s[f"{prefix}.{k}.bias"] = (n_out,)

    lstm("prop.temporal", _last(n_g, q["proposal_hidden"]) + n_what + 4, ht)
    lstm("prop.relation", ht + n_what + 4 + 1, hr)
    s.update(_mlp_shapes("prop.where.mlp", ht + hr, m["transform_hidden"]))
    head("prop.where.head", _last(ht + hr, m["transform_hidden"]), d_where)
    s.update(_mlp_shapes("prop.what.mlp", n_g, m["glimpse_encoder_hidden"]))
    head("prop.what.head",
         _last(n_g, m["glimpse_encoder_hidden"]) + ht + hr, n_what)
    pres_in = ht + hr + 4 + n_what
    s.update(_mlp_shapes("prop.pres.mlp", pres_in, m["steps_hidden"]))
    s["prop.pres.logit.weight"] = (1, _last(pres_in, m["steps_hidden"]))
    s["prop.pres.logit.bias"] = (1,)
    lstm("prior.lstm", n_what + 4, hp)
    head("prior.where", hp, d_where)
    head("prior.what", hp, n_what)
    s["prior.pres.weight"] = (1, hp)
    s["prior.pres.bias"] = (1,)
    return s


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}``, made as ``yardstick.weights.make``
    makes AIR's: every matrix from one truncated-normal draw (variance
    1/fan_in), zero biases but the presence logits' (``steps_bias``)."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device).manual_seed(derived_seed(seed, "weights"))
    mats = [s for s in shapes.values() if len(s) == 2]
    flat = torch.empty(sum(math.prod(s) for s in mats), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            n = math.prod(shape)
            std = math.sqrt(1.0 / shape[1]) / _TRUNC_STD
            params[name] = (flat[at:at + n] * std).reshape(shape)
            at += n
        else:
            params[name] = torch.zeros(shape, device=device)
    for name in PRESENCE_BIASES:
        params[name].fill_(cfg["model"]["steps_bias"])
    return params


def synthesize(bank: torch.Tensor, data: dict, seq: dict, batch: int,
               generator: torch.Generator, prec: Precision | None = None):
    """``(frames (batch, T, H, W), nums (batch,) int32)``: moving digits.

    A sequence draws its count ``k ~ U{min_digits .. max_digits}``, and
    for each of ``max_digits`` slots a bank digit, a scale, an entry frame
    ``e ~ U{0 .. max_entry_frame}``, a start (a uniform fraction of the
    in-bounds range on each axis), a speed ``U[min_speed, max_speed]``
    pixels a frame and a uniform direction, drawn in that order.  From its
    entry the digit moves in a straight line, reflected at the edges of
    the in-bounds range [-(1 - s), 1 - s] (s its half extent); a frame
    sums its present digits, clipped to [0, 1]."""
    prec = prec or Precision()
    dev = bank.device
    ch, cw = data["canvas_size"]
    dh, dw = data["digit_size"]
    slots, frames = max(data["max_digits"], 1), seq["frames"]
    lo, hi = data["scale_range"]
    kw = dict(generator=generator, device=dev)
    nums = torch.randint(data["min_digits"], data["max_digits"] + 1,
                         (batch,), **kw)
    idx = torch.randint(0, bank.shape[0], (batch, slots), **kw)
    scale = lo + (hi - lo) * torch.rand((batch, slots), **kw)
    entry = torch.randint(0, seq["max_entry_frame"] + 1, (batch, slots),
                          **kw).to(torch.float32)
    start = torch.rand((batch, slots, 2), **kw)
    speed = seq["min_speed"] + (seq["max_speed"] - seq["min_speed"]) \
        * torch.rand((batch, slots), **kw)
    angle = (2.0 * math.pi) * torch.rand((batch, slots), **kw)

    t = torch.arange(frames, dtype=torch.float32, device=dev)
    moved = torch.clamp(t - entry[..., None], min=0.0)      # (B, S, T)
    half = (scale * dw / cw, scale * dh / ch)
    vel = (speed * torch.cos(angle) * (2.0 / (cw - 1)),
           speed * torch.sin(angle) * (2.0 / (ch - 1)))
    pos = []
    for axis in range(2):
        room = torch.clamp(2.0 * (1.0 - half[axis]), min=1e-6)[..., None]
        y = torch.remainder(start[..., axis, None] * room
                            + vel[axis][..., None] * moved, 2.0 * room)
        # the folded path: up the range, then back down
        pos.append((half[axis] - 1.0)[..., None] + room
                   - torch.abs(y - room))
    zw = torch.stack([half[0][..., None].expand_as(pos[0]),
                      half[1][..., None].expand_as(pos[1]), *pos], -1)
    present = ((torch.arange(slots, device=dev)[None] < nums[:, None])
               [..., None] & (t >= entry[..., None])).to(torch.float32)
    digits = bank[idx][:, :, None].expand(-1, -1, frames, -1, -1)
    pasted = st.paste(digits.reshape(-1, dh, dw), zw.reshape(-1, 4),
                      (ch, cw), prec).reshape(batch, slots, frames, ch, cw)
    imgs = torch.clamp(torch.sum(pasted * present[..., None, None], 1),
                       0.0, 1.0)
    return imgs, nums.to(torch.int32)


def sample_noise(cfg: dict, batch: int, generator: torch.Generator, device):
    """The forward's noise in the program's order, each ``(T, N, batch,
    ...)``: propagation's window, appearance and presence draws, then
    discovery's."""
    m = cfg["model"]
    lead = (cfg["sequence"]["frames"], m["max_steps"], batch)
    out = []
    for _ in range(2):
        out += [torch.randn(lead + (len(where_indices(m)),),
                            generator=generator, device=device),
                torch.randn(lead + (m["n_what"],), generator=generator,
                            device=device),
                torch.rand(lead + (1,), generator=generator, device=device)]
    return out


def _bern(x, p):
    p = clip_preserve(p, 1e-7, 1.0 - 1e-7)
    return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)


class SQAIR(Model):
    """The forward of one configuration over a parameter dict.  The class
    switches plant faults for calibration: ``relation`` False zeroes the
    relation LSTM's state, ``disc_from_render`` False starts discovery's
    canvas at zero."""

    relation = True
    disc_from_render = True

    def __init__(self, cfg: dict, params: dict, prec: Precision | None = None):
        super().__init__(cfg, params, prec)
        self.q = cfg["sequence"]
        self.idx = list(where_indices(self.m))

    def lstm_of(self, prefix, state, x):
        c, h = state
        p = self.p
        gates = self.prec.linear(x, p[f"{prefix}.ih.weight"], None,
                                 torch.float32) \
            + self.prec.linear(h, p[f"{prefix}.hh.weight"],
                               p[f"{prefix}.hh.bias"], torch.float32)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def propagate(self, slot, rel, z_obj, img, canvas, eps_where, eps_what,
                  u_pres):
        """One slot: its outputs, the canvas and the relation state."""
        m, prec, p = self.m, self.prec, self.p
        what_prev, where_prev, pres_prev, temporal, prior = slot
        batch = img.shape[0]
        window = self.st_where(where_prev)
        rho = self.q["proposal_scale"]
        proposal = st.gather(img, torch.cat([window[:, :2] * rho,
                                             window[:, 2:]], -1),
                             m["glimpse_size"], prec)
        enc = self.mlp("prop.proposal", proposal.reshape(batch, -1),
                       self.dtype, len(self.q["proposal_hidden"]))
        temporal, h_t = self.lstm_of(
            "prop.temporal", temporal,
            torch.cat([enc, what_prev, where_prev], -1))
        if self.relation:
            rel, h_r = self.lstm_of("prop.relation", rel,
                                    torch.cat([h_t, z_obj], -1))
        else:
            h_r = torch.zeros_like(rel[1])
        states = torch.cat([h_t, h_r], -1)
        delta, where_scale = self.head(
            "prop.where.head",
            self.mlp("prop.where.mlp", states, self.dtype,
                     len(m["transform_hidden"])))
        where_loc = where_prev[:, self.idx] + delta
        z_where = self.expand_where(where_loc + where_scale * eps_where)
        prior, h_p = self.lstm_of("prior.lstm", prior,
                                  torch.cat([what_prev, where_prev], -1))
        delta, pw_scale = self.head("prior.where", h_p)
        p_where = (where_prev[:, self.idx] + delta, pw_scale)
        delta, pwhat_scale = self.head("prior.what", h_p)
        p_what = (what_prev + delta, pwhat_scale)
        p_pres = torch.sigmoid(prec.linear(h_p, p["prior.pres.weight"],
                                           p["prior.pres.bias"],
                                           torch.float32))

        glimpse = st.gather(img, self.st_where(z_where), m["glimpse_size"],
                            prec)
        feat = self.mlp("prop.what.mlp", glimpse.reshape(batch, -1),
                        self.dtype, len(m["glimpse_encoder_hidden"]))
        delta, what_scale = self.head("prop.what.head",
                                      torch.cat([feat, states], -1))
        what_loc = what_prev + delta
        z_what = what_loc + what_scale * eps_what
        x = self.mlp("prop.pres.mlp",
                     torch.cat([states, z_where, z_what], -1), self.dtype,
                     len(m["steps_hidden"]))
        pr = torch.sigmoid(prec.linear(x, p["prop.pres.logit.weight"],
                                       p["prop.pres.logit.bias"],
                                       torch.float32))
        if m["explore_eps"] is not None:
            pr = m["explore_eps"] + (1.0 - 2.0 * m["explore_eps"]) * pr
        p_eff = pr * pres_prev
        z_pres = (u_pres < p_eff).to(torch.float32)
        pasted = st.paste(self.decode(z_what), self.st_where(z_where),
                          m["img_size"], prec)
        canvas = (canvas.to(torch.float32) + z_pres[..., None] * pasted) \
            .to(self.carry_dtype)
        out = dict(where_loc=where_loc, where_scale=where_scale,
                   z_where=z_where, what_loc=what_loc, what_scale=what_scale,
                   z_what=z_what, p_eff=p_eff[:, 0], pres=z_pres,
                   prev=pres_prev[:, 0], p_where=p_where, p_what=p_what,
                   p_pres=p_pres[:, 0], temporal=temporal, prior=prior)
        return out, canvas, rel

    def forward(self, x, p_success, noise, beta=1.0):
        """``x (B, T, H, W)``, ``noise`` as ``sample_noise`` draws it; a
        dict of ``(B,)`` sums over frames and ``(B, T, ...)`` per frame."""
        m = self.m
        batch, frames = x.shape[:2]
        n, n_what = m["max_steps"], m["n_what"]
        ht, hp = self.q["temporal_hidden"], self.q["prior_hidden"]
        dev = x.device
        pw, pwhat, pu, dw, dwhat, du = noise

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        slots = [(zeros(batch, n_what), zeros(batch, 4), zeros(batch, 1),
                  (zeros(batch, ht), zeros(batch, ht)),
                  (zeros(batch, hp), zeros(batch, hp))) for _ in range(n)]
        q = torch.clamp(torch.as_tensor(p_success, dtype=torch.float32,
                                        device=dev), _EPS, 1.0 - _EPS)
        log_count = torch.arange(n + 1, dtype=torch.float32,
                                 device=dev) * torch.log(q)
        frame = {k: [] for k in ("log_w", "log_lik", "prop", "disc",
                                 "log_q", "prop_pres", "disc_pres", "pres")}
        for t in range(frames):
            img = x[:, t]
            canvas = torch.zeros(img.shape, dtype=self.carry_dtype,
                                 device=dev)
            rel = (zeros(batch, self.q["relation_hidden"]),) * 2
            z_obj = zeros(batch, n_what + 5)
            props = []
            for i in range(n):
                o, canvas, rel = self.propagate(slots[i], rel, z_obj, img,
                                                canvas, pw[t, i], pwhat[t, i],
                                                pu[t, i])
                z_obj = torch.cat([o["z_what"], o["z_where"], o["pres"]], -1)
                props.append(o)
            n_prop = sum(o["pres"] for o in props)          # (B, 1)
            carry = (canvas if self.disc_from_render else
                     torch.zeros_like(canvas),
                     (zeros(batch, m["rnn_hidden"]),) * 2,
                     zeros(batch, n_what), zeros(batch, 4), zeros(batch, 1)
                     + 1.0)
            discs = []
            for j in range(n):
                free = (n_prop + (j + 1) <= n).to(torch.float32)
                carry = (*carry[:4], carry[4] * free)
                carry, o = self.step(carry, img, dw[t, j], dwhat[t, j],
                                     du[t, j])
                discs.append(o)

            recon = carry[0].to(torch.float32) * m["output_multiplier"]
            log_lik = torch.sum(normal_log_prob(img, recon, m["output_std"]),
                                dim=(-2, -1))
            prop_t, log_q = 0.0, 0.0
            for o in props:
                z = o["z_where"][:, self.idx]
                where = torch.sum(normal_log_prob(z, *o["p_where"])
                                  - normal_log_prob(z, o["where_loc"],
                                                    o["where_scale"]), -1)
                what = torch.sum(normal_log_prob(o["z_what"], *o["p_what"])
                                 - normal_log_prob(o["z_what"], o["what_loc"],
                                                   o["what_scale"]), -1)
                pres = o["pres"][:, 0]
                lq = _bern(pres, o["p_eff"])
                lp = _bern(pres, o["p_pres"] * o["prev"])
                prop_t = prop_t + o["prev"] * (where + beta * what + lp - lq)
                log_q = log_q + o["prev"] * lq
            s = {k: torch.stack([o[k] for o in discs], 1) for k in discs[0]}
            z = s["z_where"][..., self.idx]
            where = torch.sum(normal_log_prob(z, *self.where_prior)
                              - normal_log_prob(z, s["where_loc"],
                                                s["where_scale"]), -1)
            what = torch.sum(normal_log_prob(s["z_what"], 0.0, 1.0)
                             - normal_log_prob(s["z_what"], s["what_loc"],
                                               s["what_scale"]), -1)
            n_disc = torch.sum(s["pres"], -1).long()
            room = n - n_prop.long()                        # (B, 1)
            allowed = torch.arange(n + 1, device=dev)[None] <= room
            lse = torch.logsumexp(torch.where(
                allowed, log_count[None],
                torch.full_like(log_count[None], -math.inf)), -1)
            log_p_n = torch.log(torch.exp(log_count[n_disc] - lse) + 1e-20)
            log_q_n = torch.log(presence_pmf(s["pres_prob"]).gather(
                -1, n_disc[:, None])[:, 0] + 1e-20)
            disc_t = torch.sum(s["pres"] * (where + beta * what), -1) \
                + log_p_n - log_q_n
            log_q = log_q + torch.sum(s["pres_prev"] * _bern(
                s["pres"], s["pres_prob"]), -1)

            slots = self.compact(props, s, slots)
            for k, v in (("log_w", log_lik + prop_t + disc_t),
                         ("log_lik", log_lik), ("prop", prop_t),
                         ("disc", disc_t), ("log_q", log_q),
                         ("prop_pres", torch.stack([o["pres"][:, 0]
                                                    for o in props], 1)),
                         ("disc_pres", s["pres"]),
                         ("pres", torch.cat([sl[2] for sl in slots], 1))):
                frame[k].append(v)
        per = {k: torch.stack(v, 1) for k, v in frame.items()}
        return dict(
            log_w=per["log_w"].sum(1), frame_log_w=per["log_w"],
            log_q=per["log_q"].sum(1), log_lik=per["log_lik"].sum(1),
            kl_prop=-per["prop"].sum(1), kl_disc=-per["disc"].sum(1),
            prop_pres=per["prop_pres"], disc_pres=per["disc_pres"],
            pres=per["pres"])

    def compact(self, props, s, slots):
        """The next frame's slots: the present propagated objects, then
        the present discovered ones, in order (a stable sort of the
        candidates by absence), absent ones zero."""
        n = self.m["max_steps"]
        ht, hp = self.q["temporal_hidden"], self.q["prior_hidden"]
        batch = s["pres"].shape[0]
        dev = s["pres"].device
        cands = [torch.cat([o["z_what"], o["z_where"], o["pres"],
                            *o["temporal"], *o["prior"]], -1) for o in props]
        pad = torch.zeros((batch, 2 * ht + 2 * hp), device=dev)
        cands += [torch.cat([s["z_what"][:, j], s["z_where"][:, j],
                             s["pres"][:, j, None], pad], -1)
                  for j in range(n)]
        cand = torch.stack(cands, 1)                        # (B, 2N, D)
        present = torch.cat([o["pres"] for o in props]
                            + [s["pres"][:, j, None] for j in range(n)], 1)
        order = torch.sort(1.0 - present, dim=1, stable=True).indices[:, :n]
        kept = torch.gather(present, 1, order)              # (B, N)
        out = torch.gather(cand, 1, order[..., None].expand(
            -1, -1, cand.shape[-1])) * kept[..., None]
        sizes = [self.m["n_what"], 4, 1, ht, ht, hp, hp]
        new = []
        for i in range(n):
            p = torch.split(out[:, i], sizes, -1)
            new.append((p[0], p[1], p[2], (p[3], p[4]), (p[5], p[6])))
        return new


class Trainer(rtrain.Trainer):
    """``reference.train.Trainer`` on sequences: the step's frames from
    its data generator (``synthesize``), each particle's noise in turn
    from its model generator, the VIMCO loss of the particles' log
    weights summed over frames, and the same update."""

    def __init__(self, cfg: dict, params: dict, bank: torch.Tensor,
                 base_seed: int, prec: Precision | None = None):
        super().__init__(cfg, params, bank, base_seed, prec)
        self.readings = READINGS

    def batch(self, step: int):
        dev = self.bank.device
        g_data, g_model = (torch.Generator(dev).manual_seed(s)
                           for s in rtrain.step_seeds(self.base_seed, step))
        imgs, nums = synthesize(self.bank, self.cfg["data"],
                                self.cfg["sequence"],
                                self.cfg["train"]["batch_size"], g_data,
                                self.prec)
        noises = [sample_noise(self.cfg, imgs.shape[0], g_model, dev)
                  for _ in range(self.cfg["train"]["iwae_particles"])]
        return imgs, nums, noises

    def step(self):
        cfg, s = self.cfg, self.step_no
        dev = self.bank.device
        imgs, _, noises = self.batch(s)
        model = SQAIR(cfg, self.params, self.prec)
        p_success = rtrain.prior_success_prob(cfg["prior"], s).to(dev)
        beta = rtrain.kl_beta(cfg["train"], s)
        beta = beta.to(dev) if torch.is_tensor(beta) else beta
        outs = [model.forward(imgs, p_success, noise, beta)
                for noise in noises]
        log_w = torch.stack([o["log_w"] for o in outs])
        loss, terms = vimco_loss(log_w, torch.stack([o["log_q"]
                                                     for o in outs]))
        for key, field in (("log_likelihood", "log_lik"),
                           ("kl_prop", "kl_prop"), ("kl_disc", "kl_disc")):
            terms[key] = torch.mean(torch.stack([o[field].detach()
                                                 for o in outs]))
        terms["log_w_abs"] = torch.mean(torch.abs(log_w.detach()))
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
