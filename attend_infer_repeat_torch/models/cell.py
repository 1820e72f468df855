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
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

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
    st_paste,
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
                eps_what: torch.Tensor, u_pres: torch.Tensor):
        canvas, lstm_state, z_what, z_where, z_pres = carry
        cfg = self.cfg
        batch = img.shape[0]

        # Residual encoding: encode what the canvas does not yet explain.
        # The canvas conditions q only; no gradient flows back through it.
        if cfg.residual_encoding:
            enc_in = img - canvas.detach().to(img.dtype)
        else:
            enc_in = img
        embed = self.encoder(enc_in)

        lstm_in = torch.cat([embed, z_what, z_where, z_pres], dim=-1)
        lstm_state, h = self.lstm(lstm_state, lstm_in)

        where_loc, where_scale = self.where(h)
        z_where = expand_where(cfg, where_loc + where_scale * eps_where)

        glimpse = st_gather(img, st_where(cfg, z_where), cfg.glimpse_size)
        what_loc, what_scale = self.what(glimpse.reshape(batch, -1))
        z_what = what_loc + what_scale * eps_what

        # Presence sees where the glimpse landed and what it found.
        steps_in = torch.cat([h, z_where, what_loc, what_scale], dim=-1)
        p = self.steps(steps_in)                        # (B, 1)
        pres_prev = z_pres
        p_eff = p * pres_prev                           # monotone chain
        z_pres = (u_pres < p_eff).to(torch.float32)     # hard 0/1

        glimpse_out = decoder(z_what)                   # (B, gh, gw)
        paste = st_paste(glimpse_out, st_where(cfg, z_where), cfg.img_size)
        # accumulate in f32, store at the configured carry dtype
        acc = canvas.to(torch.float32) + z_pres[..., None] * paste
        if cfg.canvas_rebuild:
            acc = acc.detach()
        canvas = acc.to(torch_dtype(cfg.canvas_carry_dtype))

        out = AIRStepOutput(
            where_loc=where_loc, where_scale=where_scale, z_where=z_where,
            what_loc=what_loc, what_scale=what_scale, z_what=z_what,
            pres_prob=p_eff[..., 0], pres=z_pres[..., 0],
            pres_prev=pres_prev[..., 0], glimpse=glimpse_out)
        return (canvas, lstm_state, z_what, z_where, z_pres), out


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
