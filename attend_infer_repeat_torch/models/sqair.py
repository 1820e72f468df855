"""Sequential AIR (SQAIR; Kosiorek, Kim, Teh & Posner 2018,
arXiv:1806.01794): AIR over the frames of a sequence, with objects that
persist from frame to frame.

A sequence has T frames and N object slots (``cfg.max_steps``); slot i
holds ``z = (z_where, z_what, z_pres)``, a temporal LSTM state and a prior
LSTM state, carried from frame to frame.  Each frame runs

1. propagation over the slots in order.  The proposal glimpse is taken at
   the slot's previous window with its scale times ``proposal_scale``; a
   temporal LSTM runs over [its encoding, the previous z_what, z_where],
   a relation LSTM over [that state, the object this frame's slot i − 1
   took] (zero at slot 1).  ``q(z_where) = N(z_where_prev + mu, sigma)``
   from both states; the glimpse at the new window gives ``q(z_what) =
   N(z_what_prev + mu, sigma)``; presence is ``Bernoulli(p · z_pres_prev)``
   (an object can only go).  The decoded glimpse is pasted into the
   frame's canvas, masked by presence (the fused paste).  The learned
   prior: an LSTM over [z_what_prev, z_where_prev], Gaussians about the
   previous values and ``p(z_pres = 1) = sigmoid(f(h)) · z_pres_prev``.
   Every term of the slot is masked by its previous presence;
2. discovery: ``AIRCell`` for N steps, its carried canvas starting at the
   propagated render, so that its residual encoding sees the frame less
   the propagated objects; step j is masked by the free slots,
   ``1[n_prop + j <= N]``, and its prior is AIR's: a truncated geometric
   count over the free slots, AIR's where prior, N(0, I) for z_what.
   (The paper conditions discovery on the propagated latents too; here
   they reach it through the residual and the slot mask alone);
3. compaction: the frame's N slots become the present propagated objects,
   then the present discovered ones, in order, by a stable gather indexed
   by cumulative presence; absent slots are zero, and a discovered object's
   temporal and prior states start at zero.

The first frame has no earlier objects: propagation runs on absent slots,
pastes nothing and adds nothing, and the frame is AIR.

A particle's log weight is the sum over frames of ``log N(x_t | canvas_t,
output_std²)``, the propagation terms (``log p - log q`` of where, what,
weighted by ``what_weight``, and presence, masked by the previous
presence) and AIR's discovery terms (the presence-masked where and what
ratios and ``log p(n) - log q(n | x_t)``).  ``log_q_pres`` scores every
presence sample of both phases, for VIMCO.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from attend_infer_repeat_torch import resolve_device
from attend_infer_repeat_torch.configs import ModelConfig, SequenceConfig
from attend_infer_repeat_torch.models.cell import AIRCell, _recompute
from attend_infer_repeat_torch.models.modules import (
    MLP,
    GaussianHead,
    GlimpseDecoder,
    LSTMCell,
    StepsPredictor,
    _width,
    compute_dtype,
    expand_where,
    init_params,
    reduce_where,
    st_where,
    torch_dtype,
    where_param_indices,
)
from attend_infer_repeat_torch.ops.distributions import (
    bernoulli_log_prob,
    normal_log_prob,
    presence_pmf,
)
from attend_infer_repeat_torch.ops.spatial_transformer import (
    st_gather,
    st_paste_accumulate,
)
from attend_infer_repeat_torch.utils.profiling import span

#: The forwards' frames and object steps since the process started:
#: ``frames``, ``prop_steps`` (propagation's) and ``disc_steps``
#: (discovery's).  A graph's warm-ups and capture count like eager steps
#: and a replay runs no Python, as ``modules.particle_counts``.
sqair_counts: collections.Counter = collections.Counter()

_EPS = 1e-15

# Injected forward noise, each (T, N, B, ...): propagation's eps_where,
# eps_what and presence uniforms, then discovery's.
Noise = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class SQAIROutputs:
    """Per-sequence outputs, batch-major."""

    log_weight: torch.Tensor          # (B,) Σ_t frame_log_weight
    frame_log_weight: torch.Tensor    # (B, T)
    log_q_pres: torch.Tensor          # (B,) every presence sample's log q
    log_likelihood: torch.Tensor      # (B,) Σ_t log p(x_t | z_t)
    kl_prop: torch.Tensor             # (B,) −Σ_t propagation log ratios
    kl_disc: torch.Tensor             # (B,) −Σ_t discovery log ratios
    prop_pres: torch.Tensor           # (B, T, N) propagation's samples
    prop_prev: torch.Tensor           # (B, T, N) their previous presence
    disc_pres: torch.Tensor           # (B, T, N) discovery's samples
    free: torch.Tensor                # (B, T) slots left for discovery
    pres: torch.Tensor                # (B, T, N) the slots after compaction
    predicted_steps: torch.Tensor     # (B,) objects in the last frame
    mode_steps = None                 # no closed-form count posterior

    def head(self, rows: int) -> "SQAIROutputs":
        """The first ``rows`` sequences of every field."""
        return SQAIROutputs(**{f.name: getattr(self, f.name)[:rows]
                               for f in dataclasses.fields(self)})


class _Where(nn.Module):
    """Features → the window's offset and scale: an MLP and a head."""

    def __init__(self, cfg: ModelConfig, n_in: int):
        super().__init__()
        self.mlp = MLP(n_in, cfg.transform_hidden, dtype=compute_dtype(cfg))
        self.head = GaussianHead(cfg, _width(n_in, cfg.transform_hidden),
                                 len(where_param_indices(cfg)))

    def forward(self, h, particles: int = 1):
        return self.head(self.mlp(h, particles), particles)


class _What(nn.Module):
    """Glimpse and states → the appearance's offset and scale."""

    def __init__(self, cfg: ModelConfig, n_states: int):
        super().__init__()
        n_in = cfg.glimpse_size[0] * cfg.glimpse_size[1]
        self.mlp = MLP(n_in, cfg.glimpse_encoder_hidden,
                       dtype=compute_dtype(cfg))
        self.head = GaussianHead(
            cfg, _width(n_in, cfg.glimpse_encoder_hidden) + n_states,
            cfg.n_what)

    def forward(self, glimpse_flat, states, particles: int = 1):
        f = self.mlp(glimpse_flat, particles)
        return self.head(torch.cat([f, states], dim=-1), particles)


class Propagation(nn.Module):
    """The propagation core: the proposal encoder, the temporal and
    relation LSTMs and the where, what and presence heads."""

    def __init__(self, cfg: ModelConfig, seq: SequenceConfig):
        super().__init__()
        n_g = cfg.glimpse_size[0] * cfg.glimpse_size[1]
        ht, hr = seq.temporal_hidden, seq.relation_hidden
        self.proposal = MLP(n_g, seq.proposal_hidden,
                            dtype=compute_dtype(cfg))
        self.temporal = LSTMCell(_width(n_g, seq.proposal_hidden)
                                 + cfg.n_what + 4, ht)
        self.relation = LSTMCell(ht + cfg.n_what + 4 + 1, hr)
        self.where = _Where(cfg, ht + hr)
        self.what = _What(cfg, ht + hr)
        self.pres = StepsPredictor(cfg, ht + hr + 4 + cfg.n_what)


class PropagationPrior(nn.Module):
    """The learned prior of a propagated object: an LSTM over the
    previous latents, Gaussian heads about them, a presence logit (f32)."""

    def __init__(self, cfg: ModelConfig, seq: SequenceConfig):
        super().__init__()
        hp = seq.prior_hidden
        self.lstm = LSTMCell(cfg.n_what + 4, hp)
        self.where = GaussianHead(cfg, hp, len(where_param_indices(cfg)))
        self.what = GaussianHead(cfg, hp, cfg.n_what)
        self.pres = nn.Linear(hp, 1)


class SQAIRModel(nn.Module):
    """Sequential AIR over ``(B, T, H, W)`` sequences.  Its parameters
    are initialized as ``AIRModel``'s are (the presence logits at
    ``steps_bias``), from a CPU generator seeded with ``seed``, then moved
    to ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, seq: SequenceConfig, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg, self.seq = cfg, seq
        self.decoder = GlimpseDecoder(cfg)
        self.cell = AIRCell(cfg)
        self.prop = Propagation(cfg, seq)
        self.prior = PropagationPrior(cfg, seq)
        w_idx = where_param_indices(cfg)
        for name, values in (("where_prior_loc", cfg.where_prior_loc),
                             ("where_prior_scale", cfg.where_prior_scale)):
            self.register_buffer(name, torch.tensor(
                [values[i] for i in w_idx], dtype=torch.float32),
                persistent=False)
        init_params(self, torch.Generator().manual_seed(seed))
        nn.init.constant_(self.prior.pres.bias, cfg.steps_bias)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.decoder.mlp.dense[0].weight.device

    def where_prior(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(loc, scale)`` of discovery's where prior."""
        return self.where_prior_loc, self.where_prior_scale

    def sample_noise(self, batch: int,
                     generator: torch.Generator | None = None) -> Noise:
        """Draw the forward's noise on the model's device, in order:
        propagation's window, appearance and presence draws, then
        discovery's, each ``(T, N, batch, ...)``."""
        cfg, dev = self.cfg, self.device
        lead = (self.seq.frames, cfg.max_steps, batch)
        d_where = len(where_param_indices(cfg))
        out = []
        for _ in range(2):
            out += [torch.randn(lead + (d_where,), generator=generator,
                                device=dev),
                    torch.randn(lead + (cfg.n_what,), generator=generator,
                                device=dev),
                    torch.rand(lead + (1,), generator=generator, device=dev)]
        return tuple(out)

    # --- propagation ------------------------------------------------------
    def _propagate(self, slot, rel, z_obj, img, canvas, eps_where, eps_what,
                   u_pres, particles):
        """One slot's propagation: returns its outputs, the canvas and the
        relation LSTM's state.  With ``cfg.remat`` its two stretches
        between the spatial-transformer calls are recomputed in the
        backward (``remat_policy`` ``save_st``), or the whole step
        (``full``), as ``AIRCell`` does."""
        cfg = self.cfg
        args = (slot, rel, z_obj, img, canvas, eps_where, eps_what, u_pres,
                particles)
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._propagate_step(*args)
        if cfg.remat_policy == "full":
            return _recompute(self._propagate_step, *args)
        if cfg.remat_policy == "save_st":
            return self._propagate_step(*args, stretch=_recompute)
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def _propagate_step(self, slot, rel, z_obj, img, canvas, eps_where,
                        eps_what, u_pres, particles, stretch=None):
        cfg = self.cfg
        what_prev, where_prev, pres_prev, temporal, prior = slot
        run = stretch or (lambda fn, *a: fn(*a))
        window = st_where(cfg, where_prev)
        rho = self.seq.proposal_scale
        proposal = st_gather(img, torch.cat([window[..., :2] * rho,
                                             window[..., 2:]], dim=-1),
                             cfg.glimpse_size)
        temporal, rel, h_t, h_r, where_loc, where_scale, z_where, prior, \
            p_where, p_what, p_pres = run(
                self._attend, proposal, what_prev, where_prev, temporal, rel,
                z_obj, prior, eps_where, particles)
        glimpse = st_gather(img, st_where(cfg, z_where), cfg.glimpse_size)
        what_loc, what_scale, z_what, p_eff, z_pres, glimpse_out = run(
            self._infer, glimpse, h_t, h_r, z_where, what_prev, pres_prev,
            eps_what, u_pres, particles)
        canvas = st_paste_accumulate(canvas, glimpse_out,
                                     st_where(cfg, z_where), z_pres)
        out = dict(where_loc=where_loc, where_scale=where_scale,
                   z_where=z_where, what_loc=what_loc, what_scale=what_scale,
                   z_what=z_what, pres_prob=p_eff, pres=z_pres,
                   pres_prev=pres_prev, p_where=p_where, p_what=p_what,
                   p_pres=p_pres, temporal=temporal, prior=prior)
        return out, canvas, rel

    def _attend(self, proposal, what_prev, where_prev, temporal, rel, z_obj,
                prior, eps_where, particles):
        """The temporal, relation and prior LSTMs and the window's sample."""
        cfg, prop = self.cfg, self.prop
        batch = proposal.shape[0]
        enc = prop.proposal(proposal.reshape(batch, -1), particles)
        temporal, h_t = prop.temporal(
            temporal, torch.cat([enc, what_prev, where_prev], dim=-1))
        rel, h_r = prop.relation(rel, torch.cat([h_t, z_obj], dim=-1))
        delta, where_scale = prop.where(torch.cat([h_t, h_r], dim=-1),
                                        particles)
        where_loc = reduce_where(cfg, where_prev) + delta
        z_where = expand_where(cfg, where_loc + where_scale * eps_where)
        prior, h_p = self.prior.lstm(
            prior, torch.cat([what_prev, where_prev], dim=-1))
        delta, p_where_scale = self.prior.where(h_p, particles)
        p_where = (reduce_where(cfg, where_prev) + delta, p_where_scale)
        delta, p_what_scale = self.prior.what(h_p, particles)
        p_what = (what_prev + delta, p_what_scale)
        p_pres = torch.sigmoid(self.prior.pres(h_p))
        return temporal, rel, h_t, h_r, where_loc, where_scale, z_where, \
            prior, p_where, p_what, p_pres

    def _infer(self, glimpse, h_t, h_r, z_where, what_prev, pres_prev,
               eps_what, u_pres, particles):
        """The appearance's sample, presence and the decoded glimpse."""
        prop = self.prop
        batch = glimpse.shape[0]
        delta, what_scale = prop.what(glimpse.reshape(batch, -1),
                                      torch.cat([h_t, h_r], dim=-1),
                                      particles)
        what_loc = what_prev + delta
        z_what = what_loc + what_scale * eps_what
        p = prop.pres(torch.cat([h_t, h_r, z_where, z_what], dim=-1),
                      particles)
        p_eff = p * pres_prev                           # only switches off
        z_pres = (u_pres < p_eff).to(torch.float32)
        return what_loc, what_scale, z_what, p_eff, z_pres, \
            self.decoder(z_what, particles)

    # --- the frame --------------------------------------------------------
    def initial_slots(self, batch: int):
        """Every slot absent: ``(what, where, pres, temporal, prior)``,
        each ``(B, N, ...)``, the states as ``(c, h)``."""
        cfg, seq, dev = self.cfg, self.seq, self.device
        n = cfg.max_steps

        def zeros(d):
            return torch.zeros((batch, n, d), device=dev)

        return (zeros(cfg.n_what), zeros(4), zeros(1),
                (zeros(seq.temporal_hidden), zeros(seq.temporal_hidden)),
                (zeros(seq.prior_hidden), zeros(seq.prior_hidden)))

    def _compact(self, prop: dict, disc):
        """The frame's slots: the present propagated objects, then the
        present discovered ones, in order; the rest zero."""
        cfg, n = self.cfg, self.cfg.max_steps
        batch = prop["pres"].shape[0]
        states = [*prop["temporal"], *prop["prior"]]
        width = sum(s.shape[-1] for s in states)
        cand = torch.cat([
            torch.cat([prop["z_what"], prop["z_where"], prop["pres"],
                       *states], dim=-1),
            torch.cat([disc.z_what, disc.z_where, disc.pres[..., None],
                       torch.zeros((batch, n, width),
                                   device=disc.z_what.device)], dim=-1)],
            dim=1)                                          # (B, 2N, D)
        present = cand[..., cfg.n_what + 4]
        # slot s takes the candidate before which s candidates are present
        ranks = torch.cumsum(present, dim=1)
        s = torch.arange(n, dtype=ranks.dtype, device=ranks.device)
        idx = torch.sum((ranks[:, None, :] <= s[None, :, None])
                        .to(torch.int64), dim=-1)           # (B, N)
        valid = idx < 2 * n
        idx = torch.clamp(idx, max=2 * n - 1)
        out = torch.gather(cand, 1, idx[..., None].expand(-1, -1,
                                                           cand.shape[-1]))
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
        sizes = [cfg.n_what, 4, 1] + [t.shape[-1] for t in states]
        parts = torch.split(out, sizes, dim=-1)
        return (parts[0], parts[1], parts[2], (parts[3], parts[4]),
                (parts[5], parts[6]))

    def forward(self, x: torch.Tensor, prior_success_prob,
                generator: torch.Generator | None = None,
                noise: Noise | None = None, particles: int = 1,
                what_weight=1.0) -> SQAIROutputs:
        """``x (B, T, H, W)``.  ``particles = k``: the batch is k equal
        blocks of rows, the particles of one wide forward
        (``modules.dense``).  ``what_weight`` scales the appearance's log
        ratios in the log weight (the IWAE counterpart of ``kl_beta``)."""
        cfg = self.cfg
        batch, frames = x.shape[:2]
        n = cfg.max_steps
        if noise is None:
            noise = self.sample_noise(batch, generator)
        pw, pwhat, pu, dw, dwhat, du = noise
        imgs = x.transpose(0, 1).contiguous()               # (T, B, H, W)
        carry_dtype = torch_dtype(cfg.canvas_carry_dtype)
        dev = x.device
        slots = self.initial_slots(batch)
        log_p_count = torch.arange(n + 1, dtype=torch.float32, device=dev) \
            * torch.log(torch.clamp(torch.as_tensor(
                prior_success_prob, dtype=torch.float32, device=dev),
                _EPS, 1.0 - _EPS))
        rows = collections.defaultdict(list)
        sqair_counts.update(frames=frames, prop_steps=frames * n,
                            disc_steps=frames * n)
        for t in range(frames):
            img = imgs[t]
            with span("sqair.propagate"):
                canvas = torch.zeros(img.shape, dtype=carry_dtype, device=dev)
                rel = (torch.zeros((batch, self.seq.relation_hidden),
                                   device=dev),) * 2
                z_obj = torch.zeros((batch, cfg.n_what + 5), device=dev)
                outs = []
                for i in range(n):
                    slot = (slots[0][:, i], slots[1][:, i], slots[2][:, i],
                            (slots[3][0][:, i], slots[3][1][:, i]),
                            (slots[4][0][:, i], slots[4][1][:, i]))
                    o, canvas, rel = self._propagate(
                        slot, rel, z_obj, img, canvas, pw[t, i], pwhat[t, i],
                        pu[t, i], particles)
                    z_obj = torch.cat([o["z_what"], o["z_where"], o["pres"]],
                                      dim=-1)
                    outs.append(o)
                prop = {k: torch.stack([o[k] for o in outs], 1)
                        for k in outs[0] if k not in
                        ("p_where", "p_what", "temporal", "prior")}
                for k in ("p_where", "p_what", "temporal", "prior"):
                    prop[k] = tuple(torch.stack([o[k][j] for o in outs], 1)
                                    for j in range(2))
            with span("sqair.discover"):
                n_prop = torch.sum(prop["pres"], dim=1)     # (B, 1)
                state = torch.zeros((batch, cfg.rnn_hidden), device=dev)
                carry = (canvas, (state, state),
                         torch.zeros((batch, cfg.n_what), device=dev),
                         torch.zeros((batch, 4), device=dev),
                         torch.ones((batch, 1), device=dev))
                steps = []
                for j in range(n):
                    free = (n_prop + (j + 1) <= n).to(torch.float32)
                    carry, o = self.cell(carry, img, self.decoder, dw[t, j],
                                         dwhat[t, j], du[t, j], particles,
                                         free=free)
                    steps.append(o)
                disc = type(steps[0])(**{
                    f.name: torch.stack([getattr(o, f.name) for o in steps],
                                        1)
                    for f in dataclasses.fields(steps[0])})
            with span("sqair.compact"):
                slots = self._compact(prop, disc)
            rows["pres"].append(slots[2][..., 0])
            self._frame(rows, img, carry[0], prop, disc, n_prop,
                        log_p_count, what_weight)
        got = {k: torch.stack(v, 1) for k, v in rows.items()}
        frame_lw = got["log_lik"] + got["prop"] + got["disc"]
        return SQAIROutputs(
            log_weight=torch.sum(frame_lw, 1), frame_log_weight=frame_lw,
            log_q_pres=torch.sum(got["log_q"], 1),
            log_likelihood=torch.sum(got["log_lik"], 1),
            kl_prop=-torch.sum(got["prop"], 1),
            kl_disc=-torch.sum(got["disc"], 1),
            prop_pres=got["prop_pres"], prop_prev=got["prop_prev"],
            disc_pres=got["disc_pres"], free=got["free"],
            pres=got["pres"], predicted_steps=torch.sum(got["pres"][:, -1],
                                                        -1))

    def _frame(self, rows, img, canvas, prop, disc, n_prop, log_p_count,
               what_weight):
        """The frame's terms of the log weight, into ``rows``."""
        cfg, n = self.cfg, self.cfg.max_steps
        recon = canvas.to(torch.float32) * cfg.output_multiplier
        rows["log_lik"].append(torch.sum(
            normal_log_prob(img, recon, cfg.output_std), dim=(-2, -1)))
        # propagation: log p − log q, masked by the previous presence
        prev = prop["pres_prev"][..., 0]                    # (B, N)
        z_w = reduce_where(cfg, prop["z_where"])
        where = torch.sum(
            normal_log_prob(z_w, *prop["p_where"])
            - normal_log_prob(z_w, prop["where_loc"], prop["where_scale"]),
            dim=-1)
        what = torch.sum(
            normal_log_prob(prop["z_what"], *prop["p_what"])
            - normal_log_prob(prop["z_what"], prop["what_loc"],
                              prop["what_scale"]), dim=-1)
        pres = prop["pres"][..., 0]
        log_q = bernoulli_log_prob(pres, prop["pres_prob"][..., 0])
        log_p = bernoulli_log_prob(pres, prop["p_pres"][..., 0] * prev)
        rows["prop"].append(torch.sum(
            prev * (where + what_weight * what + log_p - log_q), dim=-1))
        # discovery: AIR's terms, the count's prior over the free slots
        loc, scale = self.where_prior()
        z_w = reduce_where(cfg, disc.z_where)
        d_where = torch.sum(normal_log_prob(z_w, loc, scale)
                            - normal_log_prob(z_w, disc.where_loc,
                                              disc.where_scale), dim=-1)
        d_what = torch.sum(normal_log_prob(disc.z_what, 0.0, 1.0)
                           - normal_log_prob(disc.z_what, disc.what_loc,
                                             disc.what_scale), dim=-1)
        latents = torch.sum(disc.pres * (d_where + what_weight * d_what), -1)
        n_disc = torch.sum(disc.pres, dim=-1).to(torch.int64)
        room = (n - n_prop).to(torch.int64)                 # (B, 1)
        counts = torch.arange(n + 1, device=room.device)
        lse = torch.logsumexp(torch.where(
            counts[None] <= room, log_p_count[None],
            torch.full_like(log_p_count[None], -math.inf)), dim=-1)
        log_p_n = torch.log(torch.exp(log_p_count[n_disc] - lse) + 1e-20)
        log_q_n = torch.log(torch.gather(presence_pmf(disc.pres_prob), -1,
                                         n_disc[:, None])[:, 0] + 1e-20)
        rows["disc"].append(latents + log_p_n - log_q_n)
        rows["log_q"].append(
            torch.sum(prev * log_q, dim=-1)
            + torch.sum(disc.pres_prev * bernoulli_log_prob(
                disc.pres, disc.pres_prob), dim=-1))
        rows["prop_pres"].append(pres)
        rows["prop_prev"].append(prev)
        rows["disc_pres"].append(disc.pres)
        rows["free"].append(n - n_prop[:, 0])
