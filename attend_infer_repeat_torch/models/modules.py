"""Neural modules: encoders, decoder, Gaussian heads, presence predictor.

Each module mirrors its flax counterpart in ``attend_infer_repeat_tpu``
layer for layer, so that ``convert.params_from_flax`` maps one parameter
tree onto the other.  The dtype mix is written out with explicit casts:
a layer run in ``dtype`` casts its input, weight and bias to ``dtype``
(as flax ``Dense(dtype=...)`` does), and ``MLP`` returns float32.
Parameters stay float32.  A module's ``particles`` says that its batch is
that many equal blocks of rows, one per particle of a wide forward
(``dense``).

Initialization follows flax's defaults: truncated lecun-normal weights,
zero biases, orthogonal recurrent blocks in the LSTM, and ``steps_bias``
on the presence logit.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from attend_infer_repeat_torch.configs import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str | None) -> torch.dtype:
    """A config dtype name as a ``torch.dtype`` (None means float32)."""
    return _DTYPES[name or "float32"]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def decoder_dtype(cfg: ModelConfig) -> torch.dtype:
    """Generative-path dtype: ``decoder_dtype`` override, else ``dtype``."""
    return torch_dtype(cfg.decoder_dtype or cfg.dtype)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: normal truncated at ±2σ, variance 1/fan_in
    (a ``Linear`` weight's fan-in is its row, a ``Conv2d``'s its filter)."""
    # stddev of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every parameter of ``module`` as flax would."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    for m in module.modules():
        if isinstance(m, LSTMCell):        # one orthogonal block per gate
            with torch.no_grad():
                for block in m.hh.weight.chunk(4, dim=0):
                    nn.init.orthogonal_(block, generator=generator)
        elif isinstance(m, StepsPredictor):
            nn.init.constant_(m.logit.bias, m.cfg.steps_bias)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
          particles: int = 1):
    """``layer(x)`` with input, weight and bias cast to ``dtype``.

    ``particles = k > 1`` says that the rows (dim 0) come in k equal
    blocks, the k particles of one wide forward.  Where the weight is
    cast, the layer then gives each block what k forwards of one block
    each give (``_ParticleDense``): the same outputs, and weight and bias
    gradients rounded to ``dtype`` block by block and summed in float32.
    """
    if particles > 1 and layer.weight.dtype != dtype:
        if x.shape[0] % particles:
            raise ValueError(f"{x.shape[0]} rows are not {particles} "
                             "equal blocks")
        return _ParticleDense.apply(x.to(dtype), layer.weight, layer.bias,
                                    particles)
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


#: ``_ParticleDense``'s GEMM groups since the process started: ``groups``
#: (one layer's k per-particle GEMMs: a forward, a recompute or a weight
#: gradient) and ``forked`` (those run side by side on the particle
#: streams).  A graph's warm-ups and capture count like eager steps and a
#: replay runs no Python, as ``train.step.objective_counts``.
particle_counts: collections.Counter = collections.Counter()

# each CUDA device's side streams, made once, so that warm-up, capture
# and replay issue to the same streams (and cuBLAS workspaces)
_side_streams: dict = {}


@contextlib.contextmanager
def _particle_blocks(device: torch.device, k: int):
    """Run one group of k block GEMMs: yields ``on(j)``, the context that
    block j's GEMM runs under.

    On CUDA each block has a side stream of its own: the side streams
    wait for the current stream on entry and it waits for them on exit,
    so the blocks run side by side (in a capture, as parallel branches of
    the graph), each on its own stream.  Whatever the blocks write is
    allocated on the current stream before entry.  Elsewhere the blocks
    run in turn on the current stream.
    """
    particle_counts["groups"] += 1
    if device.type != "cuda":
        yield lambda j: contextlib.nullcontext()
        return
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    streams = _side_streams.setdefault(index, [])
    while len(streams) < k:
        streams.append(torch.cuda.Stream(index))
    current = torch.cuda.current_stream(index)
    fork = current.record_event()
    for s in streams[:k]:
        s.wait_event(fork)
    try:
        yield lambda j: torch.cuda.stream(streams[j])
    finally:
        for s in streams[:k]:
            current.wait_stream(s)
    particle_counts["forked"] += 1


class _ParticleDense(torch.autograd.Function):
    """``F.linear(x, weight.to(x.dtype), bias.to(x.dtype))`` over the rows
    of a 2-D ``x`` in ``particles`` equal blocks, with each block's bits
    as a forward and backward of that block alone give them.

    The forward and the weight's gradient run one GEMM a block: over all
    the rows at once, or as one batched GEMM over the blocks, cuBLAS can
    take another kernel, which splits the sum otherwise (on the H100: the
    encoder's 2,500-wide layer at 5,120 rows against 1,024 in the forward;
    the batched weight GEMM of the encoder and the heads) and so rounds
    some outputs apart.  In the forward that flips presence samples; in
    the weight's gradient it moves the first update off the loop's by
    bf16 ulps, and later steps' presence samples with it.  A group's block
    GEMMs are the calls ``F.linear`` and ``mm`` make on each block alone,
    run side by side (``_particle_blocks``), each writing its block of one
    buffer.  Each block's weight gradient is rounded to ``x.dtype`` on its
    own, and the blocks' are summed in float32.  The input's gradient is
    one GEMM (row for row the blocks' own on the H100), the bias's each
    block's row sum in ``x.dtype``, summed in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, particles):
        w, b = weight.to(x.dtype), bias.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.particles = particles
        out = x.new_empty((x.shape[0], w.shape[0]))
        with _particle_blocks(x.device, particles) as on:
            for j, (rows, o) in enumerate(zip(x.chunk(particles),
                                              out.chunk(particles))):
                with on(j):
                    torch.addmm(b, rows, w.t(), out=o)   # F.linear's call
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        k = ctx.particles
        g_x = g_w = g_b = None
        per_block = None
        if ctx.needs_input_grad[1]:
            per_block = grad.new_empty((k, *w.shape))
        group = (_particle_blocks(grad.device, k) if per_block is not None
                 else contextlib.nullcontext())
        with group as on:
            if per_block is not None:
                for j, (g, r) in enumerate(zip(grad.chunk(k), x.chunk(k))):
                    with on(j):
                        torch.mm(g.t(), r, out=per_block[j])
            # on the current stream, beside the blocks' GEMMs
            if ctx.needs_input_grad[0]:
                g_x = grad.matmul(w)
            if ctx.needs_input_grad[2]:
                g_b = torch.sum(torch.sum(grad.reshape(k, -1, grad.shape[-1]),
                                          dim=1), dim=0, dtype=torch.float32)
        if per_block is not None:
            g_w = torch.sum(per_block, dim=0, dtype=torch.float32)
        return g_x, g_w, g_b, None


def _width(in_features: int, hidden: Sequence[int]) -> int:
    return hidden[-1] if hidden else in_features


class MLP(nn.Module):
    """ELU MLP: hidden widths, then an optional linear head."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 out: int | None = None, dtype=torch.float32):
        super().__init__()
        widths = [in_features, *hidden] + ([out] if out is not None else [])
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.n_hidden = len(hidden)
        self.dtype = dtype

    def forward(self, x, particles: int = 1):
        x = x.to(self.dtype)
        for i, layer in enumerate(self.dense):
            x = dense(layer, x, self.dtype, particles)
            if i < self.n_hidden:
                x = F.elu(x)
        return x.to(torch.float32)


def same_padding(n: int, stride: int = 2, kernel: int = 3):
    """flax ``'SAME'`` padding of one axis: ``(before, after)``.

    The output has ``ceil(n / stride)`` pixels; flax pads the total that
    needs with the odd pixel after, so a stride-2 3×3 pads (0, 1) at
    n = 50 and (1, 1) at n = 25, where torch's ``padding=1`` pads (1, 1).
    """
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class Encoder(nn.Module):
    """Image encoder: image → embedding.

    With ``cfg.encoder_conv`` a stem of stride-2 3×3 convolutions (ELU,
    flax ``'SAME'`` padding) runs first and its NHWC features, flattened
    as flax flattens them, feed the MLP; without it the MLP sees the
    flattened image.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.img_size = tuple(cfg.img_size)
        self.dtype = compute_dtype(cfg)
        (h, w), c_in = self.img_size, 1
        self.conv = nn.ModuleList()
        for feat in cfg.encoder_conv:
            self.conv.append(nn.Conv2d(c_in, feat, 3, stride=2))
            (h, w), c_in = (-(-h // 2), -(-w // 2)), feat
        n_in = h * w * c_in
        self.mlp = MLP(n_in, cfg.encoder_hidden, dtype=self.dtype)
        self.out_features = _width(n_in, cfg.encoder_hidden)

    def forward(self, img, particles: int = 1):
        batch = img.shape[0]
        if not self.conv:
            return self.mlp(img.reshape(batch, -1), particles)
        if particles == 1:
            x = self._stem(img)
        else:
            # each particle's rows through the stem apart, so that each
            # one's weight gradient is rounded to ``dtype`` on its own
            x = torch.cat([self._stem(rows)
                           for rows in img.chunk(particles)])
        return self.mlp(x, particles)

    def _stem(self, img):
        """The convolutions: images → flat float32 features."""
        batch, d = img.shape[0], self.dtype
        x = img.reshape(batch, 1, *self.img_size).to(d)
        for conv in self.conv:
            (top, bottom), (left, right) = (same_padding(n)
                                            for n in x.shape[-2:])
            x = F.pad(x, (left, right, top, bottom))
            x = F.elu(F.conv2d(x, conv.weight.to(d), conv.bias.to(d),
                               stride=2))
        # flax flattens (B, h, w, C)
        return x.permute(0, 2, 3, 1).reshape(batch, -1).to(torch.float32)


class GaussianHead(nn.Module):
    """features → (loc, scale); scale = softplus(raw + offset) + min_scale."""

    def __init__(self, cfg: ModelConfig, in_features: int, event_dim: int,
                 loc_bias: Tuple[float, ...] | None = None):
        super().__init__()
        self.cfg = cfg
        self.loc = nn.Linear(in_features, event_dim)
        self.scale = nn.Linear(in_features, event_dim)
        # a buffer, so that no step copies it to the device
        self.register_buffer(
            "loc_bias", None if loc_bias is None else torch.tensor(
                loc_bias, dtype=torch.float32), persistent=False)

    def forward(self, h, particles: int = 1):
        d = compute_dtype(self.cfg)
        loc = dense(self.loc, h, d, particles).to(torch.float32)
        raw = dense(self.scale, h, d, particles).to(torch.float32)
        scale = F.softplus(raw + self.cfg.scale_offset) + self.cfg.min_scale
        if self.loc_bias is not None:
            loc = loc + self.loc_bias
        return loc, scale


def where_param_indices(cfg: ModelConfig):
    """Indices into the 4-dim (sx, sy, tx, ty) prior tuples that the
    where-posterior parameterizes."""
    return (0, 2, 3) if cfg.isotropic_scale else (0, 1, 2, 3)


def reduce_where(cfg: ModelConfig, z_where: torch.Tensor) -> torch.Tensor:
    """The 4-dim affine → the entries ``where_param_indices`` names."""
    if cfg.isotropic_scale:
        return torch.cat([z_where[..., 0:1], z_where[..., 2:]], dim=-1)
    return z_where


def expand_where(cfg: ModelConfig, z_w: torch.Tensor) -> torch.Tensor:
    """Posterior sample → 4-dim affine (sx, sy, tx, ty) for the ST."""
    if cfg.isotropic_scale:
        return torch.cat([z_w[..., 0:1], z_w[..., 0:1], z_w[..., 1:]], dim=-1)
    return z_w


def st_where(cfg: ModelConfig, z_where: torch.Tensor) -> torch.Tensor:
    """z_where as the spatial transformer consumes it.

    With ``cfg.max_scale`` the scales are capped by a true clip (zero
    gradient past the cap); the posterior and its KL stay on the raw
    sample.
    """
    if cfg.max_scale is None:
        return z_where
    s = torch.clamp(z_where[..., :2], max=cfg.max_scale)
    return torch.cat([s, z_where[..., 2:]], dim=-1)


class StochasticTransformParam(nn.Module):
    """LSTM features → q(z_where) parameters, loc biased to the prior mean."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.mlp = MLP(cfg.rnn_hidden, cfg.transform_hidden,
                       dtype=compute_dtype(cfg))
        idx = where_param_indices(cfg)
        self.head = GaussianHead(
            cfg, _width(cfg.rnn_hidden, cfg.transform_hidden), len(idx),
            loc_bias=tuple(cfg.where_prior_loc[i] for i in idx))

    def forward(self, h, particles: int = 1):
        return self.head(self.mlp(h, particles), particles)


class GlimpseEncoder(nn.Module):
    """Flat glimpse → q(z_what) parameters."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n_in = cfg.glimpse_size[0] * cfg.glimpse_size[1]
        self.mlp = MLP(n_in, cfg.glimpse_encoder_hidden,
                       dtype=compute_dtype(cfg))
        self.head = GaussianHead(
            cfg, _width(n_in, cfg.glimpse_encoder_hidden), cfg.n_what)

    def forward(self, glimpse_flat, particles: int = 1):
        return self.head(self.mlp(glimpse_flat, particles), particles)


class GlimpseDecoder(nn.Module):
    """z_what → glimpse pixels in (0, 1), in the generative dtype."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.glimpse_size = tuple(cfg.glimpse_size)
        gh, gw = self.glimpse_size
        self.mlp = MLP(cfg.n_what, cfg.decoder_hidden, out=gh * gw,
                       dtype=decoder_dtype(cfg))

    def forward(self, z_what, particles: int = 1):
        x = self.mlp(z_what, particles)
        return torch.sigmoid(x).reshape(x.shape[:-1] + self.glimpse_size)


class StepsPredictor(nn.Module):
    """Step features → presence probability, floored by ``explore_eps``."""

    def __init__(self, cfg: ModelConfig, in_features: int):
        super().__init__()
        self.cfg = cfg
        self.mlp = MLP(in_features, cfg.steps_hidden,
                       dtype=compute_dtype(cfg))
        self.logit = nn.Linear(_width(in_features, cfg.steps_hidden), 1)

    def forward(self, h, particles: int = 1):
        p = torch.sigmoid(self.logit(self.mlp(h, particles)))  # f32 layer
        eps = self.cfg.explore_eps
        if eps is not None:
            p = eps + (1.0 - 2.0 * eps) * p
        return p  # (..., 1)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: gates i, f, g, o; bias on the hidden
    path only; state ``(c, h)``.  Runs in float32."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.ih = nn.Linear(in_features, 4 * hidden, bias=False)
        self.hh = nn.Linear(hidden, 4 * hidden)

    def forward(self, state, x):
        c, h = state
        i, f, g, o = (self.ih(x) + self.hh(h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class BaselineMLP(nn.Module):
    """NVIL input-dependent baseline: (image, per-step features) → (B, T).

    Its first layer acts on ``concat([image broadcast over T, features])``
    without building the concat: the weight is split at the image width,
    the image product runs once per example and is broadcast over steps.
    """

    def __init__(self, cfg: ModelConfig, feat_features: int):
        super().__init__()
        self.img_features = cfg.img_size[0] * cfg.img_size[1]
        self.mlp = MLP(self.img_features + feat_features,
                       cfg.baseline_hidden, out=1, dtype=compute_dtype(cfg))

    def forward(self, img_flat, step_features):
        # img_flat (B, H*W); step_features (B, T, F)
        mlp, d, da = self.mlp, self.mlp.dtype, self.img_features
        first = mlp.dense[0]
        w = first.weight.to(d)
        x = (img_flat.to(d) @ w[:, :da].t())[..., None, :] \
            + step_features.to(d) @ w[:, da:].t() + first.bias.to(d)
        for i, layer in enumerate(mlp.dense):
            if i:
                x = dense(layer, x, d)
            if i < mlp.n_hidden:
                x = F.elu(x)
        return x.to(torch.float32)[..., 0]
