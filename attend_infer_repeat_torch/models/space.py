"""SPACE (Lin, Wu, Peri, Sun, Singh, Deng, Jiang & Ahn, ICLR 2020,
arXiv:2001.02407): a grid of object cells inferred all in parallel over a
K-component mixture background.

Foreground, on a ``(B, C, H, W)`` scene and a G × G grid of cells:

1. an image encoder (stride-2 and 3 × 3 convs) down to ``(B, 128, G, G)``,
   a lateral context (two 3 × 3 convs) joined to it by a 3 × 3 conv, and
   1 × 1 heads per cell: the presence logit, and the loc and scale of
   ``z_depth`` (1), ``z_scale`` (2) and ``z_shift`` (2);
2. presence as a relaxed Bernoulli in logit space at temperature τ:
   ``y = (logit + log u − log(1 − u)) / τ``, ``z_pres = sigmoid(y)``, its
   KL one sample of ``log q(y) − log p(y)`` against the prior logit
   ``logit(ρ)`` (ρ annealed: ``Config.prior``);
3. the window: ``s = sigmoid(z_scale)`` of the image side per axis and
   the centre ``2 (k + 0.5 + tanh(z_shift)) / G − 1`` of cell k's
   column and row, so within one cell of its own centre; the glimpse of
   each colour channel is the indexed gather of the scene at it
   (``ops/st_kernel.py``: 256 windows of one image, no copy per window);
4. a glimpse encoder (convs down to 1 × 1, a 1 × 1 head) to ``q(z_what)``,
   and a decoder (a 1 × 1 conv, PixelShuffle blocks, a 3 × 3 conv and a
   1 × 1 head) to the object's colour ``o = sigmoid(·)`` and alpha
   ``sigmoid(·)``;
5. the render: ``α̂ = z_pres · α``; ``(α̂ · o, α̂)`` pasted into the scene
   at the inverse window (one-to-one, four rows an object); the
   importance ``γ = α̂_pasted · importance · sigmoid(−z_depth)``; weights
   ``w = softmax over the cells of γ`` at every pixel; ``μ_fg = Σ w P``
   and ``α_fg = Σ w A``.

Background, K components (GENESIS-style): an encoder (4 × 4 stride-2 convs
and a linear) to ``h``; two K-step LSTM chains, the posterior's over
``[h, z_mask_{k−1}]`` and the prior's over ``z_mask_{k−1}``, each a
Gaussian of a linear on its state; the masks ``m_k = sigmoid(Dec_m)`` by
stick-breaking, ``π_k = m_k Π_{j<k} (1 − m_j)`` and ``π_K = Π_{j<K}
(1 − m_j)`` (in log space); per component ``q(z_comp)`` of an encoder of
``[x, π_k]``, its prior an MLP of ``z_mask_k``, and ``μ_k =
sigmoid(Dec_c(z_comp))``.  Everything after the two chains runs batched
over the K components.

Likelihood per pixel, each channel Gaussian:
``log p(x_p) = logsumexp(log α_fg + log N(x_p | μ_fg), log(1 − α_fg) +
logsumexp_k [log π_k + log N(x_p | μ_k)])``, ``α_fg`` clamped to
``[1e-5, 1 − 1e-5]``.  The ELBO subtracts ``Σ_c KL_pres + z_pres (KL_where
+ KL_depth + KL_what)`` and ``Σ_k KL_mask + KL_comp``; every Gaussian KL
is analytic, every scale ``softplus(raw) + 1e-4``, and every gradient
reparameterised.  Every conv but a head is followed by GroupNorm and
CELU.  The reference (``air_bench/reference/space.py``) notes where this
departs from the paper.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from attend_infer_repeat_torch import resolve_device
from attend_infer_repeat_torch.configs import ModelConfig, SpaceConfig
from attend_infer_repeat_torch.models.modules import LSTMCell, init_params
from attend_infer_repeat_torch.ops import st_kernel
from attend_infer_repeat_torch.ops.distributions import (
    logit_relaxed_bernoulli_log_prob,
    logit_relaxed_bernoulli_sample,
    normal_kl,
    normal_log_prob,
)
from attend_infer_repeat_torch.ops.math import linear_anneal
from attend_infer_repeat_torch.ops.spatial_transformer import invert_where
from attend_infer_repeat_torch.utils import graphs
from attend_infer_repeat_torch.utils.profiling import span

#: A forward's work: ``cells`` (object cells inferred), ``glimpses`` (the
#: indexed gather's windows: a cell's glimpse of each channel) and
#: ``components`` (background components), carried as
#: ``modules.lstm_counts`` is: a graph's warm-ups count, its capture does
#: not, and each replay adds one captured run's (``utils/graphs.py``).
space_counts: collections.Counter = collections.Counter()
graphs.carry(__name__, "space_counts")

#: Added to every softplus scale, and the bounds of ``α_fg``.
MIN_SCALE = 1e-4
ALPHA_CLAMP = 1e-5

# Injected forward noise: the presence uniforms (B, G²), eps of z_depth
# (B, G², 1), z_scale (B, G², 2), z_shift (B, G², 2), z_what (B, G², Z),
# z_mask (B, K, Zm) and z_comp (B, K, Zc).
Noise = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class SpaceOutputs:
    """Per-scene ELBO terms, batch-major, each ``(B,)``."""

    elbo: torch.Tensor
    log_likelihood: torch.Tensor
    kl_pres: torch.Tensor             # Σ_c log q(y) − log p(y)
    kl_where: torch.Tensor            # Σ_c z_pres · (KL z_scale + z_shift)
    kl_depth: torch.Tensor            # Σ_c z_pres · KL z_depth
    kl_what: torch.Tensor             # Σ_c z_pres · KL z_what
    kl_bg: torch.Tensor               # Σ_k KL z_mask + KL z_comp
    predicted_steps: torch.Tensor     # cells with z_pres > 0.5
    mode_steps = None                 # no closed-form count posterior


@contextlib.contextmanager
def conv_algorithms():
    """cuDNN's fastest deterministic algorithm for each conv of the
    enclosed steps, forward and backward (``cudnn.benchmark`` with
    ``cudnn.deterministic``; the flags are put back after).  Each shape is
    timed once, at its first use: a graph's first warm-up, before the
    capture, so that the captured step and an eager one run the same
    algorithms and give the same bits.  Without it cuDNN's default
    choices for the glimpse convs (8,192 glimpses at batch 32) are FFT
    and legacy backward kernels, ~1.6× the step time, and a captured step
    differs from an eager one in the last bits."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = True, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = before


def _scale(raw: torch.Tensor) -> torch.Tensor:
    return F.softplus(raw) + MIN_SCALE


def _gaussian(raw: torch.Tensor, dim: int = -1):
    """``(loc, scale)`` of a head's output, its halves along ``dim``."""
    loc, raw_scale = raw.chunk(2, dim=dim)
    return loc, _scale(raw_scale)


class ConvNorm(nn.Module):
    """A conv, GroupNorm (``group`` channels a group) and CELU."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, group: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, padding)
        self.norm = nn.GroupNorm(max(c_out // group, 1), c_out)

    def forward(self, x):
        return F.celu(self.norm(self.conv(x)))


class UpBlock(nn.Module):
    """A 3 × 3 conv to four times the width, PixelShuffle(2), GroupNorm
    and CELU: twice the side."""

    def __init__(self, c_in: int, c_out: int, group: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, 4 * c_out, 3, 1, 1)
        self.norm = nn.GroupNorm(max(c_out // group, 1), c_out)

    def forward(self, x):
        return F.celu(self.norm(F.pixel_shuffle(self.conv(x), 2)))


def _convs(c_in: int, specs, group: int) -> nn.Sequential:
    """``ConvNorm`` layers of ``(width, kernel, stride, padding)``."""
    layers = []
    for width, kernel, stride, padding in specs:
        layers.append(ConvNorm(c_in, width, kernel, stride, padding, group))
        c_in = width
    return nn.Sequential(*layers)


class Decoder(nn.Module):
    """A latent ``(N, Z)`` to ``(N, out, S, S)``: a 1 × 1 conv at 1 × 1 to
    ``widths[0]``, an ``UpBlock`` to each later width, an optional 3 × 3
    ``ConvNorm`` to ``last``, and a 1 × 1 head to ``out`` channels."""

    def __init__(self, z: int, widths, out: int, group: int,
                 last: int | None = None):
        super().__init__()
        self.inp = ConvNorm(z, widths[0], 1, 1, 0, group)
        self.blocks = nn.Sequential(*(UpBlock(a, b, group)
                                      for a, b in zip(widths[:-1],
                                                      widths[1:])))
        width = widths[-1]
        self.last = None
        if last is not None:
            self.last = ConvNorm(width, last, 3, 1, 1, group)
            width = last
        self.head = nn.Conv2d(width, out, 1)

    def forward(self, z):
        x = self.blocks(self.inp(z[..., None, None]))
        if self.last is not None:
            x = self.last(x)
        return self.head(x)


class Foreground(nn.Module):
    """The image encoder, lateral context, per-cell heads and the glimpse
    encoder and decoder."""

    def __init__(self, space: SpaceConfig):
        super().__init__()
        g = space.group_channels
        self.enc = _convs(space.channels, space.fg_encoder, g)
        width = space.fg_encoder[-1][0]
        self.lateral = _convs(width, [(w, 3, 1, 1) for w in space.lateral],
                              g)
        lat = space.lateral[-1] if space.lateral else width
        self.fuse = ConvNorm(width + lat, width, 3, 1, 1, g)
        # presence logit, z_depth, z_scale, z_shift (locs, then scales)
        self.head = nn.Conv2d(width, 1 + 2 * (1 + 2 + 2), 1)
        self.glimpse_enc = _convs(space.channels, space.glimpse_encoder, g)
        self.glimpse_head = nn.Conv2d(space.glimpse_encoder[-1][0],
                                      2 * space.z_what, 1)
        self.glimpse_dec = Decoder(space.z_what, space.glimpse_decoder,
                                   space.channels + 1, g,
                                   last=space.glimpse_decoder_out)


class Background(nn.Module):
    """The mask and component VAEs and their two K-step LSTM chains."""

    def __init__(self, space: SpaceConfig, img_size):
        super().__init__()
        g = space.group_channels
        specs = [(w, 4, 2, 1) for w in space.bg_encoder]
        side_h = img_size[0] >> len(specs)
        side_w = img_size[1] >> len(specs)
        flat = space.bg_encoder[-1] * side_h * side_w
        self.enc = _convs(space.channels, specs, g)
        self.embed = nn.Linear(flat, space.bg_embed)
        self.mask_lstm = LSTMCell(space.bg_embed + space.z_mask,
                                  space.mask_hidden)
        self.mask_post = nn.Linear(space.mask_hidden, 2 * space.z_mask)
        self.mask_prior_lstm = LSTMCell(space.z_mask, space.mask_hidden)
        self.mask_prior = nn.Linear(space.mask_hidden, 2 * space.z_mask)
        self.mask_dec = Decoder(space.z_mask, space.bg_decoder, 1, g)
        self.comp_enc = _convs(space.channels + 1, specs, g)
        self.comp_embed = nn.Linear(flat, 2 * space.z_comp)
        self.comp_prior = nn.Sequential(
            nn.Linear(space.z_mask, space.comp_prior_hidden), nn.CELU(),
            nn.Linear(space.comp_prior_hidden, 2 * space.z_comp))
        self.comp_dec = Decoder(space.z_comp, space.bg_decoder,
                                space.channels, g)


def init_biases(module: nn.Module, generator: torch.Generator) -> None:
    """Every conv's and linear's bias uniform in ``±1/sqrt(fan_in)``, as
    PyTorch initializes them.  A window off the scene gives an all-zero
    glimpse, and with zero biases a GroupNorm would then normalize a group
    of zeros, whose backward scales by ``1/sqrt(eps)`` at every layer."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            with torch.no_grad():
                m.bias.uniform_(-bound, bound, generator=generator)


class SpaceModel(nn.Module):
    """SPACE over ``(B, C, H, W)`` scenes of ``cfg.img_size``.  Its
    parameters are initialized from a CPU generator seeded with ``seed``
    (lecun-normal matrices as ``AIRModel``'s, biases as ``init_biases``,
    GroupNorm at 1 and 0), then moved to ``device`` (CUDA unless
    ``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, space: SpaceConfig, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg, self.space = cfg, space
        self.fg = Foreground(space)
        self.bg = Background(space, cfg.img_size)
        g = space.grid
        col = torch.arange(g, dtype=torch.float32).repeat(g)
        row = torch.arange(g, dtype=torch.float32).repeat_interleave(g)
        self.register_buffer("cell_offset", torch.stack([col, row], -1),
                             persistent=False)              # (G², 2): x, y
        gen = torch.Generator().manual_seed(seed)
        init_params(self, gen)
        init_biases(self, gen)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.fg.head.weight.device

    def schedule(self, step: int) -> torch.Tensor:
        """The model's own entries of a step's schedule row: ``z_scale``'s
        prior mean, annealed linearly (float32, ``(1,)``)."""
        s = self.space
        return linear_anneal(step, s.z_scale_mean[0], s.z_scale_mean[1],
                             *s.z_scale_anneal).reshape(1)

    def sample_noise(self, batch: int,
                     generator: torch.Generator | None = None) -> Noise:
        """Draw the forward's noise on the model's device, in order: the
        presence uniforms, then eps of z_depth, z_scale, z_shift, z_what,
        z_mask and z_comp."""
        s, dev = self.space, self.device
        cells, k = s.grid * s.grid, s.components
        kw = dict(generator=generator, device=dev)
        return (torch.rand((batch, cells), **kw),
                torch.randn((batch, cells, 1), **kw),
                torch.randn((batch, cells, 2), **kw),
                torch.randn((batch, cells, 2), **kw),
                torch.randn((batch, cells, s.z_what), **kw),
                torch.randn((batch, k, s.z_mask), **kw),
                torch.randn((batch, k, s.z_comp), **kw))

    # --- the foreground ---------------------------------------------------
    def _cells(self, x, prior_prob, z_scale_mean, u, eps_depth, eps_scale,
               eps_shift):
        """The per-cell latents and their KL terms."""
        s, fg = self.space, self.fg
        e = fg.enc(x)
        f = fg.fuse(torch.cat([e, fg.lateral(e)], dim=1))
        heads = fg.head(f).flatten(2).transpose(1, 2)       # (B, G², 11)
        logit = heads[..., 0]
        depth = heads[..., 1:2], _scale(heads[..., 6:7])
        scale = heads[..., 2:4], _scale(heads[..., 7:9])
        shift = heads[..., 4:6], _scale(heads[..., 9:11])
        y = logit_relaxed_bernoulli_sample(logit, u, s.tau)
        prior_logit = torch.log(prior_prob) - torch.log1p(-prior_prob)
        kl_pres = logit_relaxed_bernoulli_log_prob(y, logit, s.tau) \
            - logit_relaxed_bernoulli_log_prob(y, prior_logit, s.tau)
        z_depth = depth[0] + depth[1] * eps_depth
        z_scale = scale[0] + scale[1] * eps_scale
        z_shift = shift[0] + shift[1] * eps_shift
        kl_where = torch.sum(normal_kl(*scale, z_scale_mean, s.z_scale_std)
                             + normal_kl(*shift, 0.0, 1.0), dim=-1)
        kl_depth = normal_kl(*depth, 0.0, 1.0)[..., 0]
        centre = 2.0 * (self.cell_offset + 0.5 + torch.tanh(z_shift)) \
            / s.grid - 1.0
        z_where = torch.cat([torch.sigmoid(z_scale), centre], dim=-1)
        return torch.sigmoid(y), z_depth, z_where, kl_pres, kl_where, \
            kl_depth

    def _glimpses(self, x, z_where, eps_what):
        """Each cell's glimpse of every channel, ``q(z_what)``, its KL and
        the decoded colour and alpha ``(B·G², C + 1, h, w)``."""
        s, fg = self.space, self.fg
        batch, c = x.shape[:2]
        cells = z_where.shape[1]
        zw = z_where[:, :, None].expand(-1, -1, c, -1).reshape(-1, 4)
        # glimpse (b, cell, ch) reads row b·C + ch of the scene
        src = (torch.arange(batch, device=x.device)[:, None, None] * c
               + torch.arange(c, device=x.device)).expand(-1, cells, -1)
        glimpse = st_kernel.STGather.apply(
            x.reshape((-1,) + tuple(x.shape[-2:])).contiguous(),
            zw.contiguous(), tuple(s.glimpse_size),
            src.reshape(-1).to(torch.int32))
        glimpse = glimpse.reshape((batch * cells, c) + tuple(s.glimpse_size))
        loc, scale = _gaussian(fg.glimpse_head(fg.glimpse_enc(glimpse))
                               .flatten(1))
        z_what = loc + scale * eps_what.reshape(loc.shape)
        kl_what = torch.sum(normal_kl(loc, scale, 0.0, 1.0), dim=-1)
        return torch.sigmoid(fg.glimpse_dec(z_what)), \
            kl_what.reshape(batch, cells)

    def _render(self, decoded, z_pres, z_depth, z_where, img_shape):
        """``(μ_fg (B, C, H, W), α_fg (B, H, W))``."""
        s = self.space
        batch, cells = z_pres.shape
        colour, alpha = decoded[:, :-1], decoded[:, -1:]
        a_hat = z_pres.reshape(-1, 1, 1, 1) * alpha
        rgba = torch.cat([a_hat * colour, a_hat], dim=1)    # (B·G², C+1, h, w)
        rows = rgba.shape[1]
        inv = invert_where(z_where).reshape(-1, 1, 4).expand(-1, rows, -1)
        pasted = st_kernel.STGather.apply(
            rgba.reshape((-1,) + tuple(rgba.shape[-2:])).contiguous(),
            inv.reshape(-1, 4).contiguous(), tuple(img_shape))
        pasted = pasted.reshape((batch, cells, rows) + tuple(img_shape))
        gamma = pasted[:, :, -1] * (s.importance * torch.sigmoid(-z_depth)
                                    )[..., None, None]      # (B, G², H, W)
        w = torch.softmax(gamma, dim=1)
        fg = torch.sum(w[:, :, None] * pasted, dim=1)       # (B, C+1, H, W)
        return fg[:, :-1], fg[:, -1]

    # --- the background ---------------------------------------------------
    def _background(self, x, eps_mask, eps_comp):
        """``(log π (B, K, H, W), μ (B, K, C, H, W), KL (B,))``."""
        s, bg = self.space, self.bg
        batch, k = x.shape[0], s.components
        h = bg.embed(bg.enc(x).flatten(1))
        z_prev = torch.zeros((batch, s.z_mask), device=x.device)
        state = torch.zeros((batch, s.mask_hidden), device=x.device)
        post, prior = (state, state), (state, state)
        kl, z_masks = 0.0, []
        for i in range(k):
            post, hq = bg.mask_lstm(post, torch.cat([h, z_prev], dim=-1))
            loc, scale = _gaussian(bg.mask_post(hq))
            z = loc + scale * eps_mask[:, i]
            prior, hp = bg.mask_prior_lstm(prior, z_prev)
            kl = kl + torch.sum(normal_kl(loc, scale,
                                          *_gaussian(bg.mask_prior(hp))), -1)
            z_masks.append(z)
            z_prev = z
        z_mask = torch.stack(z_masks, dim=1)                # (B, K, Zm)
        logits = bg.mask_dec(z_mask.flatten(0, 1))
        logits = logits.reshape((batch, k) + tuple(x.shape[-2:]))
        log_m, log_rest = F.logsigmoid(logits), F.logsigmoid(-logits)
        scope, log_pi = torch.zeros_like(log_m[:, 0]), []
        for i in range(k - 1):
            log_pi.append(log_m[:, i] + scope)
            scope = scope + log_rest[:, i]
        log_pi = torch.stack(log_pi + [scope], dim=1)       # (B, K, H, W)
        inp = torch.cat([x[:, None].expand(-1, k, -1, -1, -1),
                         torch.exp(log_pi)[:, :, None]], dim=2)
        loc, scale = _gaussian(bg.comp_embed(
            bg.comp_enc(inp.flatten(0, 1)).flatten(1)))
        z_comp = loc + scale * eps_comp.flatten(0, 1)
        p_loc, p_scale = _gaussian(bg.comp_prior(z_mask.flatten(0, 1)))
        kl = kl + torch.sum(normal_kl(loc, scale, p_loc, p_scale),
                            -1).reshape(batch, k).sum(-1)
        mu = torch.sigmoid(bg.comp_dec(z_comp))
        return log_pi, mu.reshape((batch, k) + tuple(x.shape[1:])), kl

    def forward(self, x: torch.Tensor, prior_prob, z_scale_mean,
                generator: torch.Generator | None = None,
                noise: Noise | None = None) -> SpaceOutputs:
        """``x (B, C, H, W)``; ``prior_prob`` ρ and ``z_scale_mean`` (0-d
        or ``(1,)`` tensors of the step's schedule row)."""
        s = self.space
        batch = x.shape[0]
        if noise is None:
            noise = self.sample_noise(batch, generator)
        u, eps_depth, eps_scale, eps_shift, eps_what, eps_mask, eps_comp = \
            noise
        space_counts.update(cells=batch * s.grid * s.grid,
                            glimpses=batch * s.grid * s.grid * s.channels,
                            components=batch * s.components)
        with span("space.fg"):
            z_pres, z_depth, z_where, kl_pres, kl_where, kl_depth = \
                self._cells(x, prior_prob, z_scale_mean, u, eps_depth,
                            eps_scale, eps_shift)
            decoded, kl_what = self._glimpses(x, z_where, eps_what)
        with span("space.render"):
            mu_fg, alpha_fg = self._render(decoded, z_pres, z_depth[..., 0],
                                           z_where, x.shape[-2:])
        with span("space.bg"):
            log_pi, mu_bg, kl_bg = self._background(x, eps_mask, eps_comp)
        alpha_fg = torch.clamp(alpha_fg, ALPHA_CLAMP, 1.0 - ALPHA_CLAMP)
        fg = torch.log(alpha_fg) + torch.sum(
            normal_log_prob(x, mu_fg, s.fg_std), dim=1)
        bg = torch.log1p(-alpha_fg) + torch.logsumexp(
            log_pi + torch.sum(normal_log_prob(x[:, None], mu_bg, s.bg_std),
                               dim=2), dim=1)
        log_lik = torch.sum(torch.logsumexp(torch.stack([fg, bg]), dim=0),
                            dim=(-2, -1))
        kl_pres = torch.sum(kl_pres, -1)
        kl_where = torch.sum(z_pres * kl_where, -1)
        kl_depth = torch.sum(z_pres * kl_depth, -1)
        kl_what = torch.sum(z_pres * kl_what, -1)
        return SpaceOutputs(
            elbo=log_lik - kl_pres - kl_where - kl_depth - kl_what - kl_bg,
            log_likelihood=log_lik, kl_pres=kl_pres, kl_where=kl_where,
            kl_depth=kl_depth, kl_what=kl_what, kl_bg=kl_bg,
            predicted_steps=torch.sum((z_pres > 0.5).to(torch.float32), -1))
