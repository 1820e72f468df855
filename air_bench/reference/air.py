"""AIR in plain PyTorch: parameters, forward, ELBO and the NVIL loss.

Written from the model's description (Eslami et al. 2016) in the form
this repository trains it: a residual-encoding inference network (MLP
encoder, LSTM, a Gaussian window posterior, a bilinear glimpse, a
Gaussian appearance posterior, a presence Bernoulli on a monotone chain,
an MLP decoder pasted back into the canvas), the analytic KLs masked by
presence, the exact KL of the count, and the NVIL surrogate with an
input-dependent baseline.  Parameters are a dict of float32 tensors by
name; each product runs in the precision the configuration states
(``precision.Precision``).  Configurations are the dicts of
``air_bench/configs/<name>.json``; the options no configuration there
uses (a convolutional stem, a rebuilt canvas, advantage normalisation,
an L2 term, the VIMCO objective) raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from air_bench.reference import st
from air_bench.reference.precision import Precision

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}
_EPS = 1e-15


def check_supported(cfg: dict) -> None:
    m, t = cfg["model"], cfg["train"]
    unsupported = {
        "model.encoder_conv": bool(m["encoder_conv"]),
        "model.canvas_rebuild": m["canvas_rebuild"],
        "train.advantage_norm": t["advantage_norm"],
        "train.l2_weight": bool(t["l2_weight"]),
        "train.objective != elbo": t["objective"] != "elbo",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"the reference has no {', '.join(bad)}")


def where_indices(m: dict):
    return (0, 2, 3) if m["isotropic_scale"] else (0, 1, 2, 3)


def _mlp_shapes(prefix, n_in, hidden, out=None):
    widths = [n_in, *hidden] + ([out] if out is not None else [])
    shapes = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"{prefix}.dense.{i}.weight"] = (b, a)
        shapes[f"{prefix}.dense.{i}.bias"] = (b,)
    return shapes


def _last(n_in, hidden):
    return hidden[-1] if hidden else n_in


def param_shapes(m: dict, use_baseline: bool) -> dict:
    """Every parameter's name and shape, in the order the model lists
    them."""
    gh, gw = m["glimpse_size"]
    h_img, w_img = m["img_size"]
    n_what, hid, t = m["n_what"], m["rnn_hidden"], m["max_steps"]
    d_where = len(where_indices(m))
    s = {}
    s.update(_mlp_shapes("decoder.mlp", n_what, m["decoder_hidden"], gh * gw))
    s.update(_mlp_shapes("cell.encoder.mlp", h_img * w_img,
                         m["encoder_hidden"]))
    enc = _last(h_img * w_img, m["encoder_hidden"])
    s["cell.lstm.ih.weight"] = (4 * hid, enc + n_what + 4 + 1)
    s["cell.lstm.hh.weight"] = (4 * hid, hid)
    s["cell.lstm.hh.bias"] = (4 * hid,)
    s.update(_mlp_shapes("cell.where.mlp", hid, m["transform_hidden"]))
    tw = _last(hid, m["transform_hidden"])
    for k in ("loc", "scale"):
        s[f"cell.where.head.{k}.weight"] = (d_where, tw)
        s[f"cell.where.head.{k}.bias"] = (d_where,)
    s.update(_mlp_shapes("cell.what.mlp", gh * gw,
                         m["glimpse_encoder_hidden"]))
    ww = _last(gh * gw, m["glimpse_encoder_hidden"])
    for k in ("loc", "scale"):
        s[f"cell.what.head.{k}.weight"] = (n_what, ww)
        s[f"cell.what.head.{k}.bias"] = (n_what,)
    steps_in = hid + 4 + 2 * n_what
    s.update(_mlp_shapes("cell.steps.mlp", steps_in, m["steps_hidden"]))
    s["cell.steps.logit.weight"] = (1, _last(steps_in, m["steps_hidden"]))
    s["cell.steps.logit.bias"] = (1,)
    if use_baseline:
        feats = 2 * d_where + 4 + n_what + 2 + t
        s.update(_mlp_shapes("baseline.mlp", h_img * w_img + feats,
                             m["baseline_hidden"], 1))
    return s


class Model:
    """The forward of one configuration over a parameter dict."""

    def __init__(self, cfg: dict, params: dict, prec: Precision | None = None):
        check_supported(cfg)
        self.m = cfg["model"]
        self.p = params
        self.prec = prec or Precision()
        self.dtype = _DTYPES[self.m["dtype"]]
        self.dec_dtype = _DTYPES[self.m["decoder_dtype"] or self.m["dtype"]]
        self.carry_dtype = _DTYPES[self.m["canvas_carry_dtype"]]
        idx = where_indices(self.m)
        dev = next(iter(params.values())).device
        self.where_prior = tuple(
            torch.tensor([self.m[k][i] for i in idx], dtype=torch.float32,
                         device=dev)
            for k in ("where_prior_loc", "where_prior_scale"))

    # --- layers -----------------------------------------------------------
    def dense(self, name, x, dtype):
        return self.prec.linear(x, self.p[name + ".weight"],
                                self.p[name + ".bias"], dtype)

    def mlp(self, prefix, x, dtype, n_hidden):
        """ELU after each hidden layer, in ``dtype``; float32 out."""
        x = x.to(dtype)
        i = 0
        while f"{prefix}.dense.{i}.weight" in self.p:
            x = self.dense(f"{prefix}.dense.{i}", x, dtype)
            if i < n_hidden:
                x = F.elu(x)
            i += 1
        return x.to(torch.float32)

    def head(self, prefix, h, loc_bias=None):
        m = self.m
        loc = self.dense(prefix + ".loc", h, self.dtype).to(torch.float32)
        raw = self.dense(prefix + ".scale", h, self.dtype).to(torch.float32)
        scale = F.softplus(raw + m["scale_offset"]) + m["min_scale"]
        if loc_bias is not None:
            loc = loc + loc_bias
        return loc, scale

    def expand_where(self, z):
        if self.m["isotropic_scale"]:
            return torch.cat([z[..., 0:1], z[..., 0:1], z[..., 1:]], dim=-1)
        return z

    def st_where(self, z_where):
        cap = self.m["max_scale"]
        if cap is None:
            return z_where
        return torch.cat([torch.clamp(z_where[..., :2], max=cap),
                          z_where[..., 2:]], dim=-1)

    def decode(self, z_what):
        gh, gw = self.m["glimpse_size"]
        x = self.mlp("decoder.mlp", z_what, self.dec_dtype,
                     len(self.m["decoder_hidden"]))
        return torch.sigmoid(x).reshape(x.shape[:-1] + (gh, gw))

    def lstm(self, state, x):
        c, h = state
        p = self.p
        gates = self.prec.linear(x, p["cell.lstm.ih.weight"], None,
                                 torch.float32) \
            + self.prec.linear(h, p["cell.lstm.hh.weight"],
                               p["cell.lstm.hh.bias"], torch.float32)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def presence(self, feats):
        m = self.m
        x = self.mlp("cell.steps.mlp", feats, self.dtype,
                     len(m["steps_hidden"]))
        p = torch.sigmoid(self.prec.linear(
            x, self.p["cell.steps.logit.weight"],
            self.p["cell.steps.logit.bias"], torch.float32))
        eps = m["explore_eps"]
        if eps is not None:
            p = eps + (1.0 - 2.0 * eps) * p
        return p

    def baseline(self, img_flat, feats):
        d, p = self.dtype, self.p
        da = img_flat.shape[-1]
        w = p["baseline.mlp.dense.0.weight"]
        x = self.prec.mm(img_flat, w[:, :da].t(), d)[..., None, :] \
            + self.prec.mm(feats, w[:, da:].t(), d) \
            + p["baseline.mlp.dense.0.bias"].to(d)
        n_hidden = len(self.m["baseline_hidden"])
        i = 0
        while f"baseline.mlp.dense.{i}.weight" in p:
            if i:
                x = self.dense(f"baseline.mlp.dense.{i}", x, d)
            if i < n_hidden:
                x = F.elu(x)
            i += 1
        return x.to(torch.float32)[..., 0]

    # --- the model --------------------------------------------------------
    def step(self, carry, img, eps_where, eps_what, u_pres):
        m, prec = self.m, self.prec
        canvas, lstm_state, z_what, z_where, z_pres = carry
        batch = img.shape[0]
        enc_in = img - canvas.detach().to(img.dtype) \
            if m["residual_encoding"] else img
        embed = self.mlp("cell.encoder.mlp", enc_in.reshape(batch, -1),
                         self.dtype, len(m["encoder_hidden"]))
        lstm_state, h = self.lstm(
            lstm_state, torch.cat([embed, z_what, z_where, z_pres], dim=-1))
        where_loc, where_scale = self.head(
            "cell.where.head",
            self.mlp("cell.where.mlp", h, self.dtype,
                     len(m["transform_hidden"])),
            self.where_prior[0])
        z_where = self.expand_where(where_loc + where_scale * eps_where)
        glimpse = st.gather(img, self.st_where(z_where), m["glimpse_size"],
                            prec)
        what_loc, what_scale = self.head(
            "cell.what.head",
            self.mlp("cell.what.mlp", glimpse.reshape(batch, -1), self.dtype,
                     len(m["glimpse_encoder_hidden"])))
        z_what = what_loc + what_scale * eps_what
        p = self.presence(torch.cat([h, z_where, what_loc, what_scale],
                                    dim=-1))
        pres_prev = z_pres
        p_eff = p * pres_prev
        z_pres = (u_pres < p_eff).to(torch.float32)
        glimpse_out = self.decode(z_what)
        pasted = st.paste(glimpse_out, self.st_where(z_where),
                          m["img_size"], prec)
        canvas = (canvas.to(torch.float32) + z_pres[..., None] * pasted) \
            .to(self.carry_dtype)
        out = dict(where_loc=where_loc, where_scale=where_scale,
                   z_where=z_where, what_loc=what_loc, what_scale=what_scale,
                   z_what=z_what, pres_prob=p_eff[..., 0],
                   pres=z_pres[..., 0], pres_prev=pres_prev[..., 0])
        return (canvas, lstm_state, z_what, z_where, z_pres), out

    def forward(self, x, p_success, noise):
        """Outputs of the batch ``x (B, H, W)`` for its noise
        ``(eps_where (T, B, d), eps_what (T, B, n_what), u_pres (T, B, 1))``."""
        m = self.m
        batch, t_steps = x.shape[0], m["max_steps"]
        dev = x.device
        hid, n_what = m["rnn_hidden"], m["n_what"]

        def zeros(d):
            return torch.zeros((batch, d), dtype=torch.float32, device=dev)

        carry = (torch.zeros(x.shape, dtype=self.carry_dtype, device=dev),
                 (zeros(hid), zeros(hid)), zeros(n_what), zeros(4),
                 torch.ones((batch, 1), dtype=torch.float32, device=dev))
        outs = []
        for t in range(t_steps):
            carry, o = self.step(carry, x, noise[0][t], noise[1][t],
                                 noise[2][t])
            outs.append(o)
        s = {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}
        canvas = carry[0].to(torch.float32) * m["output_multiplier"]
        log_lik = torch.sum(normal_log_prob(x, canvas, m["output_std"]),
                            dim=(-2, -1))
        kl_where = torch.sum(torch.sum(normal_kl(
            s["where_loc"], s["where_scale"], *self.where_prior), -1)
            * s["pres"], -1)
        kl_what = torch.sum(torch.sum(normal_kl(
            s["what_loc"], s["what_scale"], 0.0, 1.0), -1) * s["pres"], -1)
        pmf = presence_pmf(s["pres_prob"])
        kl_steps = tabular_kl(pmf, geometric_prior(p_success, t_steps, dev))
        out = dict(
            elbo=log_lik - kl_what - kl_where - kl_steps, kl_what=kl_what,
            kl_where=kl_where, kl_steps=kl_steps,
            canvas=canvas, steps=s,
            mode_steps=torch.argmax(pmf, dim=-1).to(torch.float32),
            baseline=None)
        if "baseline.mlp.dense.0.weight" in self.p:
            feats = torch.cat([
                s["where_loc"], s["where_scale"], s["z_where"], s["what_loc"],
                s["pres_prev"][..., None], s["pres_prob"][..., None]],
                dim=-1).detach()
            ids = torch.eye(t_steps, device=dev).expand(batch, t_steps,
                                                        t_steps)
            out["baseline"] = self.baseline(
                x.reshape(batch, -1).detach(),
                torch.cat([feats, ids], dim=-1))
        return out


def sample_noise(m: dict, batch: int, generator: torch.Generator, device):
    """The forward's noise, drawn in the order the served and trained
    model draw it: window, appearance, presence uniforms."""
    t, d_where = m["max_steps"], len(where_indices(m))
    return (torch.randn((t, batch, d_where), generator=generator,
                        device=device),
            torch.randn((t, batch, m["n_what"]), generator=generator,
                        device=device),
            torch.rand((t, batch, 1), generator=generator, device=device))


def clip_preserve(x, lo, hi):
    """``clamp(x)`` forward, identity backward."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def normal_log_prob(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * (z * z + math.log(2.0 * math.pi)) - math.log(scale)


def normal_kl(loc_q, scale_q, loc_p, scale_p):
    var_ratio = (scale_q / scale_p) ** 2
    mean_term = ((loc_q - loc_p) / scale_p) ** 2
    return 0.5 * (var_ratio + mean_term - 1.0 - torch.log(var_ratio))


def presence_pmf(p):
    """``(B, T)`` chain probabilities -> ``(B, T + 1)`` count pmf."""
    cp = [p[..., 0]]
    for t in range(1, p.shape[-1]):
        cp.append(cp[-1] * p[..., t])
    cp = torch.cat([torch.ones_like(p[..., :1]), torch.stack(cp, dim=-1)], -1)
    p_next = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    return cp * (1.0 - p_next)


def geometric_prior(q, n_steps: int, device):
    q = torch.clamp(torch.as_tensor(q, dtype=torch.float32, device=device),
                    _EPS, 1.0 - _EPS)
    log_pmf = torch.arange(n_steps + 1, dtype=torch.float32,
                           device=device) * torch.log(q)
    return torch.exp(log_pmf - torch.logsumexp(log_pmf, dim=-1))


def tabular_kl(q, p):
    q = clip_preserve(q, _EPS, 1.0)
    p = clip_preserve(p, _EPS, 1.0)
    return torch.sum(q * (torch.log(q) - torch.log(p)), dim=-1)


def nvil_loss(out: dict, kl_beta):
    """The NVIL surrogate: reparameterised ELBO (z_what KL weighted by
    ``kl_beta``), REINFORCE on the presence chain against the baseline,
    and the baseline's regression.  Returns ``(loss, terms)``: the batch
    means of the ELBO and its KL terms, and the baseline's regression."""
    s = out["steps"]
    obj = out["elbo"] + (1.0 - kl_beta) * out["kl_what"]
    p = clip_preserve(s["pres_prob"], 1e-7, 1.0 - 1e-7)
    log_q = s["pres_prev"] * (s["pres"] * torch.log(p)
                              + (1.0 - s["pres"]) * torch.log1p(-p))
    signal = obj.detach()[:, None]
    if out["baseline"] is not None:
        advantage = signal - out["baseline"].detach()
        mse = torch.mean(torch.sum((out["baseline"] - signal) ** 2, dim=-1))
    else:
        advantage, mse = signal, torch.zeros((), device=obj.device)
    loss = torch.mean(-obj - torch.sum(advantage * log_q, dim=-1)) + mse
    terms = {k: torch.mean(out[k]).detach()
             for k in ("elbo", "kl_what", "kl_where", "kl_steps")}
    return loss, dict(terms, baseline_mse=mse.detach())
