"""AIRModel: generative model, inference network, and ELBO assembly.

``forward`` runs the cell over ``max_steps`` objects, then builds the
likelihood, the presence-masked analytic KLs and the exact count KL;
``generate`` samples scenes from the prior.  Both take their noise from a
``torch.Generator`` on the model's device, or injected by the caller.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from attend_infer_repeat_torch import resolve_device
from attend_infer_repeat_torch.configs import ModelConfig
from attend_infer_repeat_torch.models.cell import (
    AIRCell,
    AIRStepOutput,
    initial_carry,
)
from attend_infer_repeat_torch.models.modules import (
    BaselineMLP,
    GlimpseDecoder,
    expand_where,
    init_params,
    st_where,
    where_param_indices,
)
from attend_infer_repeat_torch.ops.distributions import (
    geometric_prior,
    normal_kl,
    normal_log_prob,
    presence_pmf,
    tabular_kl,
)
from attend_infer_repeat_torch.ops.spatial_transformer import st_paste


@dataclasses.dataclass
class AIROutputs:
    """Per-example outputs; ``steps`` is batch-major ``(B, T, ...)``."""

    elbo: torch.Tensor                # (B,)
    log_likelihood: torch.Tensor      # (B,)
    kl_what: torch.Tensor             # (B,)
    kl_where: torch.Tensor            # (B,)
    kl_steps: torch.Tensor            # (B,)
    canvas: torch.Tensor              # (B, H, W) reconstruction
    glimpses: torch.Tensor            # (B, T, gh, gw) decoded appearances
    steps: AIRStepOutput              # (B, T, ...) per-step stats
    num_steps_pmf: torch.Tensor       # (B, T+1) posterior over counts
    expected_steps: torch.Tensor      # (B,) E[n | x]
    predicted_steps: torch.Tensor     # (B,) sampled count Σ_t z_pres_t
    mode_steps: torch.Tensor          # (B,) argmax_k q(n=k | x)
    baseline: Optional[torch.Tensor]  # (B, T) NVIL baseline values or None

    def head(self, rows: int) -> "AIROutputs":
        """The first ``rows`` examples of every batch-major field."""
        def cut(t):
            return None if t is None else t[:rows]
        steps = AIRStepOutput(**{
            f.name: cut(getattr(self.steps, f.name))
            for f in dataclasses.fields(AIRStepOutput)})
        return AIROutputs(**{
            f.name: steps if f.name == "steps" else cut(getattr(self, f.name))
            for f in dataclasses.fields(AIROutputs)})


# Injected forward noise: eps_where (T, B, d_where), eps_what (T, B, n_what),
# u_pres (T, B, 1).
Noise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class AIRModel(nn.Module):
    """Attend-Infer-Repeat.  ``use_baseline=False`` drops the NVIL baseline.

    Parameters are initialized as flax initializes the JAX model, from a
    CPU generator seeded with ``seed``, then moved to ``device`` (CUDA
    unless ``device="cpu"``).
    """

    def __init__(self, cfg: ModelConfig, use_baseline: bool = True,
                 device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.use_baseline = use_baseline
        self.decoder = GlimpseDecoder(cfg)
        self.cell = AIRCell(cfg)
        if use_baseline:
            d_where = len(where_param_indices(cfg))
            feats = 2 * d_where + 4 + cfg.n_what + 2 + cfg.max_steps
            self.baseline = BaselineMLP(cfg, feats)
        # the where prior, as buffers so that no step copies it
        w_idx = where_param_indices(cfg)
        for name, values in (("where_prior_loc", cfg.where_prior_loc),
                             ("where_prior_scale", cfg.where_prior_scale)):
            self.register_buffer(name, torch.tensor(
                [values[i] for i in w_idx], dtype=torch.float32),
                persistent=False)
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.decoder.mlp.dense[0].weight.device

    def with_config(self, cfg: ModelConfig) -> "AIRModel":
        """This model under another config, over the SAME ``Parameter``
        objects: training either one trains both.  ``cfg`` may differ only
        in switches read at run time (``max_scale``, ``explore_eps``)."""
        memo = {id(t): t for t in (*self.parameters(), *self.buffers())}
        memo[id(self.cfg)] = cfg        # every submodule holds this object
        return copy.deepcopy(self, memo)

    def where_prior(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(loc, scale)`` of the where prior over the posterior's entries."""
        return self.where_prior_loc, self.where_prior_scale

    def sample_noise(self, batch: int,
                     generator: torch.Generator | None = None) -> Noise:
        """Draw the forward's noise on the model's device."""
        cfg, dev = self.cfg, self.device
        t = cfg.max_steps
        d_where = len(where_param_indices(cfg))
        return (torch.randn((t, batch, d_where), generator=generator,
                            device=dev),
                torch.randn((t, batch, cfg.n_what), generator=generator,
                            device=dev),
                torch.rand((t, batch, 1), generator=generator, device=dev))

    def forward(self, x: torch.Tensor, prior_success_prob,
                generator: torch.Generator | None = None,
                noise: Noise | None = None,
                particles: int = 1) -> AIROutputs:
        """``particles = k`` says that the batch is k equal blocks of rows,
        the k particles of one wide forward: each bf16 layer then gives
        each block what a forward of that block alone gives, outputs and
        weight gradients (``modules.dense``)."""
        cfg = self.cfg
        batch = x.shape[0]
        t_steps = cfg.max_steps
        if noise is None:
            noise = self.sample_noise(batch, generator)
        eps_where, eps_what, u_pres = noise

        carry = initial_carry(cfg, x)
        per_step = []
        for t in range(t_steps):
            carry, out = self.cell(carry, x, self.decoder, eps_where[t],
                                   eps_what[t], u_pres[t], particles)
            per_step.append(out)
        steps = AIRStepOutput(**{
            f.name: torch.stack([getattr(o, f.name) for o in per_step], 1)
            for f in dataclasses.fields(AIRStepOutput)})
        glimpses = steps.glimpse                              # (B, T, gh, gw)
        pres = steps.pres                                     # (B, T)
        if cfg.canvas_rebuild:
            # the carried canvas is conditioning only; rebuild the f32
            # reconstruction from the per-step glimpses
            gh, gw = cfg.glimpse_size
            pastes = st_paste(
                glimpses.reshape(batch * t_steps, gh, gw),
                st_where(cfg, steps.z_where).reshape(batch * t_steps, 4),
                cfg.img_size).reshape(batch, t_steps, *cfg.img_size)
            canvas = torch.sum(pastes * pres[..., None, None], dim=1) \
                * cfg.output_multiplier
        else:
            canvas = carry[0].to(torch.float32) * cfg.output_multiplier

        log_lik = torch.sum(normal_log_prob(x, canvas, cfg.output_std),
                            dim=(-2, -1))

        prior_loc, prior_scale = self.where_prior()
        kl_where_t = torch.sum(normal_kl(steps.where_loc, steps.where_scale,
                                         prior_loc, prior_scale), dim=-1)
        kl_what_t = torch.sum(normal_kl(steps.what_loc, steps.what_scale,
                                        0.0, 1.0), dim=-1)
        kl_where = torch.sum(kl_where_t * pres, dim=-1)
        kl_what = torch.sum(kl_what_t * pres, dim=-1)

        pmf = presence_pmf(steps.pres_prob)                   # (B, T+1)
        prior_pmf = geometric_prior(prior_success_prob, t_steps,
                                    device=x.device)
        kl_steps = tabular_kl(pmf, prior_pmf)

        elbo = log_lik - kl_what - kl_where - kl_steps

        baseline = None
        if self.use_baseline:
            feats = torch.cat([
                steps.where_loc, steps.where_scale, steps.z_where,
                steps.what_loc, steps.pres_prev[..., None],
                steps.pres_prob[..., None]], dim=-1).detach()
            step_ids = torch.eye(t_steps, device=x.device).expand(
                batch, t_steps, t_steps)
            feats = torch.cat([feats, step_ids], dim=-1)
            baseline = self.baseline(x.reshape(batch, -1).detach(), feats)

        ks = torch.arange(t_steps + 1, dtype=torch.float32, device=x.device)
        return AIROutputs(
            elbo=elbo, log_likelihood=log_lik, kl_what=kl_what,
            kl_where=kl_where, kl_steps=kl_steps, canvas=canvas,
            glimpses=glimpses, steps=steps, num_steps_pmf=pmf,
            expected_steps=torch.sum(pmf * ks, dim=-1),
            predicted_steps=torch.sum(pres, dim=-1),
            mode_steps=torch.argmax(pmf, dim=-1).to(torch.float32),
            baseline=baseline)

    def generate_noise(self, batch: int, prior_success_prob,
                       generator: torch.Generator | None = None):
        """Draw ``generate``'s noise ``(n (B,), eps_what (B, T, n_what),
        eps_where (B, T, d))`` on the model's device."""
        cfg, dev = self.cfg, self.device
        t_steps = cfg.max_steps
        prior_pmf = geometric_prior(prior_success_prob, t_steps, device=dev)
        d_where = len(where_param_indices(cfg))
        n = torch.multinomial(prior_pmf + 1e-20, batch, replacement=True,
                              generator=generator)
        eps_what = torch.randn((batch, t_steps, cfg.n_what),
                               generator=generator, device=dev)
        eps_where = torch.randn((batch, t_steps, d_where),
                                generator=generator, device=dev)
        return n, eps_what, eps_where

    def generate(self, batch: int, prior_success_prob,
                 generator: torch.Generator | None = None,
                 noise: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                 | None = None) -> torch.Tensor:
        """Sample images from p(x, z): ``(batch, H, W)``.

        ``noise = (n (B,), eps_what (B, T, n_what), eps_where (B, T, d))``
        injects the object counts and the latent draws (``generate_noise``
        draws them otherwise).
        """
        cfg, dev = self.cfg, self.device
        t_steps = cfg.max_steps
        if noise is None:
            noise = self.generate_noise(batch, prior_success_prob, generator)
        n, eps_what, eps_where = noise
        step_idx = torch.arange(t_steps, device=dev)
        pres = (step_idx[None, :] < n[:, None]).to(torch.float32)

        loc, scale = self.where_prior()
        z_where = expand_where(cfg, loc + scale * eps_where)
        glimpses = self.decoder(eps_what)
        canvases = st_paste(glimpses, st_where(cfg, z_where), cfg.img_size)
        return torch.sum(canvases * pres[..., None, None], dim=1) \
            * cfg.output_multiplier
