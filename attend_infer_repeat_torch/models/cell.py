"""The AIR recurrent cell: one attend-infer step.

Per step t:
  1. encode the residual image (x − canvas so far), run the LSTM over
     [embedding, z_what_{t-1}, z_where_{t-1}, z_pres_{t-1}];
  2. q(z_where_t) from the LSTM state; reparameterized sample;
  3. attend: bilinear glimpse gather at z_where_t;
  4. q(z_what_t) from the glimpse; reparameterized sample;
  5. presence: Bernoulli(p_t · z_pres_{t-1}), a hard 0/1 sample on a
     monotone chain;
  6. decode the glimpse and paste it into the carried canvas.

The model runs the cell in a Python loop over ``max_steps``.  The noise
of each step is handed in (``eps_where``, ``eps_what``, ``u_pres``), so a
caller can draw it from a ``torch.Generator`` or inject it.

With ``cfg.remat`` the backward recomputes the cell's activations instead
of keeping them (``torch.utils.checkpoint``, non-reentrant), as the JAX
package's ``make_scan_cell`` does with ``nn.remat``:
  - ``remat_policy="full"`` checkpoints the whole step, so the backward
    runs the gather and the paste again;
  - ``remat_policy="save_st"`` checkpoints the two stretches between the
    spatial-transformer calls (encoder → LSTM → where, then what →
    presence → decoder) and runs the gather and the paste outside them,
    so autograd keeps what their backward needs and the backward launches
    no forward kernel (JAX: ``save_only_these_names("st_gather",
    "st_paste")``).
    A selective-checkpoint policy would not see ``STGather``, a Python
    ``autograd.Function``, so the split is written out.
The noise comes in as tensors and the stretches draw none, so a
recompute sees the same numbers; ``checkpoint``'s RNG stash (which would
not cover explicit generators anyway) is turned off.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from attend_infer_repeat_torch.configs import ModelConfig
from attend_infer_repeat_torch.models.modules import (
    Encoder,
    GlimpseDecoder,
    GlimpseEncoder,
    LSTMCell,
    StepsPredictor,
    StochasticTransformParam,
    expand_where,
    st_where,
    torch_dtype,
)
from attend_infer_repeat_torch.ops.spatial_transformer import (
    st_gather,
    st_paste_accumulate,
)


@dataclasses.dataclass
class AIRStepOutput:
    """Per-step posterior statistics and samples."""

    where_loc: torch.Tensor     # (B, 4) or (B, 3) when isotropic
    where_scale: torch.Tensor
    z_where: torch.Tensor       # (B, 4)
    what_loc: torch.Tensor      # (B, n_what)
    what_scale: torch.Tensor
    z_what: torch.Tensor
    pres_prob: torch.Tensor     # (B,) effective presence prob p_t · pres_{t-1}
    pres: torch.Tensor          # (B,) hard 0/1 sample
    pres_prev: torch.Tensor     # (B,) presence of the previous step
    glimpse: torch.Tensor       # (B, gh, gw) decoded appearance


# canvas, LSTM state (c, h), z_what, z_where, z_pres
Carry = Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
              torch.Tensor, torch.Tensor, torch.Tensor]


class AIRCell(nn.Module):
    """One attend-infer-repeat step.

    The decoder is owned by the model and handed to each call, so that
    the in-loop decode and ``generate`` share its weights.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        lstm_in = self.encoder.out_features + cfg.n_what + 4 + 1
        self.lstm = LSTMCell(lstm_in, cfg.rnn_hidden)
        self.where = StochasticTransformParam(cfg)
        self.what = GlimpseEncoder(cfg)
        self.steps = StepsPredictor(cfg, cfg.rnn_hidden + 4 + 2 * cfg.n_what)

    def forward(self, carry: Carry, img: torch.Tensor,
                decoder: GlimpseDecoder, eps_where: torch.Tensor,
                eps_what: torch.Tensor, u_pres: torch.Tensor,
                particles: int = 1, free: torch.Tensor | None = None):
        """``free (B, 1)``, where given, masks the carried presence before
        the step: 0 where no slot is left for another object (SQAIR's
        discovery), so the step and the rest of the chain are absent."""
        cfg = self.cfg
        if free is not None:
            carry = (*carry[:4], carry[4] * free)
        args = (carry, img, decoder, eps_where, eps_what, u_pres, particles)
        if not (cfg.remat and torch.is_grad_enabled()):
            return self._step(*args)
        if cfg.remat_policy == "full":
            return _recompute(self._step, *args)
        if cfg.remat_policy == "save_st":
            return self._step(*args, stretch=_recompute)
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def _step(self, carry: Carry, img: torch.Tensor,
              decoder: GlimpseDecoder, eps_where: torch.Tensor,
              eps_what: torch.Tensor, u_pres: torch.Tensor,
              particles: int = 1, stretch=None):
        """One step; ``stretch(fn, *args)`` runs the two stretches between
        the spatial-transformer calls (``save_st`` checkpoints them).
        ``particles`` (the row blocks of a wide forward, ``modules.dense``)
        is an argument of each stretch, so that a recompute sees it."""
        canvas, lstm_state, z_what, z_where, z_pres = carry
        cfg = self.cfg
        run = stretch or (lambda fn, *a: fn(*a))

        lstm_state, h, where_loc, where_scale, z_where = run(
            self._attend, img, canvas, lstm_state, z_what, z_where, z_pres,
            eps_where, particles)
        glimpse = st_gather(img, st_where(cfg, z_where), cfg.glimpse_size)
        what_loc, what_scale, z_what, p_eff, pres_prev, z_pres, \
            glimpse_out = run(self._infer, glimpse, h, z_where, z_pres,
                              decoder, eps_what, u_pres, particles)
        # paste, accumulate in f32, store at the carry's dtype: one kernel
        canvas = st_paste_accumulate(canvas, glimpse_out,
                                     st_where(cfg, z_where), z_pres)
        if cfg.canvas_rebuild:
            canvas = canvas.detach()

        out = AIRStepOutput(
            where_loc=where_loc, where_scale=where_scale, z_where=z_where,
            what_loc=what_loc, what_scale=what_scale, z_what=z_what,
            pres_prob=p_eff[..., 0], pres=z_pres[..., 0],
            pres_prev=pres_prev[..., 0], glimpse=glimpse_out)
        return (canvas, lstm_state, z_what, z_where, z_pres), out

    def _attend(self, img, canvas, lstm_state, z_what, z_where, z_pres,
                eps_where, particles):
        """Residual encoding, LSTM and the where posterior's sample."""
        cfg = self.cfg
        # Residual encoding: encode what the canvas does not yet explain.
        # The canvas conditions q only; no gradient flows back through it.
        if cfg.residual_encoding:
            enc_in = img - canvas.detach().to(img.dtype)
        else:
            enc_in = img
        embed = self.encoder(enc_in, particles)

        lstm_in = torch.cat([embed, z_what, z_where, z_pres], dim=-1)
        lstm_state, h = self.lstm(lstm_state, lstm_in)

        where_loc, where_scale = self.where(h, particles)
        z_where = expand_where(cfg, where_loc + where_scale * eps_where)
        return lstm_state, h, where_loc, where_scale, z_where

    def _infer(self, glimpse, h, z_where, z_pres, decoder, eps_what, u_pres,
               particles):
        """The what posterior, presence, and the decoded glimpse."""
        batch = glimpse.shape[0]
        what_loc, what_scale = self.what(glimpse.reshape(batch, -1),
                                         particles)
        z_what = what_loc + what_scale * eps_what

        # Presence sees where the glimpse landed and what it found.
        steps_in = torch.cat([h, z_where, what_loc, what_scale], dim=-1)
        p = self.steps(steps_in, particles)             # (B, 1)
        pres_prev = z_pres
        p_eff = p * pres_prev                           # monotone chain
        z_pres = (u_pres < p_eff).to(torch.float32)     # hard 0/1

        glimpse_out = decoder(z_what, particles)        # (B, gh, gw)
        return what_loc, what_scale, z_what, p_eff, pres_prev, z_pres, \
            glimpse_out


# recompute in the backward; the stretches draw no random numbers
_recompute = functools.partial(checkpoint, use_reentrant=False,
                               preserve_rng_state=False)


def initial_carry(cfg: ModelConfig, img: torch.Tensor) -> Carry:
    """Zero carry; presence starts at 1 (chain alive)."""
    batch = img.shape[0]

    def zeros(d):
        return torch.zeros((batch, d), dtype=torch.float32, device=img.device)

    canvas0 = torch.zeros(img.shape, dtype=torch_dtype(cfg.canvas_carry_dtype),
                          device=img.device)
    return (canvas0, (zeros(cfg.rnn_hidden), zeros(cfg.rnn_hidden)),
            zeros(cfg.n_what), zeros(4),
            torch.ones((batch, 1), dtype=torch.float32, device=img.device))
