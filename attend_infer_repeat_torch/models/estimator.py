"""Gradient estimator: reparameterization + NVIL/REINFORCE surrogate loss.

The whole objective is one scalar whose gradient is the AIR estimator,
with ``.detach()`` where the JAX package has ``stop_gradient``:

  loss = mean( −obj                                     # reparam path
               − (L − b_t).detach() · Σ_t log q(z_pres_t)  # REINFORCE
               + (b_t − L.detach())² )                  # baseline regression

``obj`` is the ELBO with the z_what KL weighted by ``kl_beta``; the
learning signal ``L`` is ``obj`` detached.  The baseline's inputs are
detached inside the model, so the MSE term reaches baseline parameters
only, and the REINFORCE term only the presence probabilities.

The monotone-chain log q(z_pres):  once the chain has stopped
(pres_prev = 0) the step's log-prob is masked out —
``log q = Σ_t pres_prev_t · log Bern(pres_t; p_t)``.

``vimco_surrogate_loss`` is the k-particle IWAE objective with VIMCO
leave-one-out control variates, trained on ``log_importance_weights``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from attend_infer_repeat_torch.models.air import AIROutputs
from attend_infer_repeat_torch.ops.distributions import bernoulli_log_prob


def presence_log_prob(outputs: AIROutputs) -> torch.Tensor:
    """Per-step log q(z_pres_t | chain) masked by the previous presence.

    ``pres_prob`` is the effective prob (already multiplied by the sampled
    previous presence), which equals the raw conditional wherever the mask
    is 1.  Returns (B, T).
    """
    s = outputs.steps
    return s.pres_prev * bernoulli_log_prob(s.pres, s.pres_prob)


def surrogate_loss(outputs: AIROutputs, l2_params_norm=0.0,
                   l2_weight: float = 0.0, kl_beta=1.0,
                   advantage_norm: bool = False,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single scalar surrogate whose gradient is the AIR estimator.

    Returns (loss, metrics); metrics are batch means of the ELBO
    decomposition plus estimator diagnostics.  ``kl_beta`` down-weights
    the z_what KL only, in the objective only; reported metrics use the
    true ELBO.  ``advantage_norm`` rescales the centered signal by
    ``max(1, σ̂)`` of the batch.
    """
    elbo = outputs.elbo                                      # (B,)
    # relative to the true elbo, so kl_beta == 1 is bitwise elbo
    obj = outputs.elbo + (1.0 - kl_beta) * outputs.kl_what   # (B,)
    log_q = presence_log_prob(outputs)                       # (B, T)

    signal = obj.detach()[:, None]                           # (B, 1)
    if outputs.baseline is not None:
        advantage = signal - outputs.baseline.detach()       # (B, T)
        baseline_mse = torch.mean(
            torch.sum((outputs.baseline - signal) ** 2, dim=-1))
    else:
        advantage = signal
        baseline_mse = torch.zeros((), device=elbo.device)

    adv_std = None
    if advantage_norm:
        adv_std = torch.sqrt(torch.mean(torch.square(
            advantage - torch.mean(advantage))) + 1e-8)
        advantage = advantage / torch.clamp(adv_std.detach(), min=1.0)

    reinforce = torch.sum(advantage * log_q, dim=-1)         # (B,)

    loss = torch.mean(-obj - reinforce) + baseline_mse
    if l2_weight:
        loss = loss + l2_weight * l2_params_norm

    metrics = {
        "elbo": torch.mean(elbo),
        "log_likelihood": torch.mean(outputs.log_likelihood),
        "kl_what": torch.mean(outputs.kl_what),
        "kl_where": torch.mean(outputs.kl_where),
        "kl_steps": torch.mean(outputs.kl_steps),
        "baseline_mse": baseline_mse,
        "advantage_abs": torch.mean(torch.abs(advantage)),
        "expected_steps": torch.mean(outputs.expected_steps),
        "predicted_steps": torch.mean(outputs.predicted_steps),
    }
    if adv_std is not None:
        metrics["advantage_std"] = adv_std
    return loss, metrics


def count_accuracy(outputs: AIROutputs, true_counts: torch.Tensor,
                   use_mode: bool = False) -> torch.Tensor:
    """Fraction of images whose inferred object count matches the truth.

    ``use_mode=False`` compares the sampled count ``Σ_t z_pres_t``;
    ``use_mode=True`` the MAP count of the closed-form count posterior.
    """
    pred = outputs.mode_steps if use_mode else outputs.predicted_steps
    return torch.mean((pred == true_counts.to(pred.dtype)).to(torch.float32))


def vimco_surrogate_loss(log_w: torch.Tensor, log_q_pres: torch.Tensor,
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """k-particle IWAE objective with VIMCO leave-one-out baselines.

    ``log_w (k, B)``: differentiable per-particle log importance weights
    (``log_importance_weights``); ``log_q_pres (k, B)``: log-prob of each
    particle's sampled presence chain.  The loss's gradient is
    ``−∇ E[L̂]``: the pathwise ``∇ logsumexp`` plus the score term
    ``Σ_j (L̂ − L̂_{−j}).detach() ∇log q(pres_j)``, where ``L̂_{−j}`` replaces
    particle j's log weight by the mean of the others'.  Requires k ≥ 2.
    """
    k = log_w.shape[0]
    if k < 2:
        raise ValueError(f"VIMCO needs k >= 2 particles, got k={k}")
    logk = math.log(float(k))
    bound = torch.logsumexp(log_w, dim=0) - logk              # (B,)

    loo_mean = (torch.sum(log_w, dim=0)[None] - log_w) / (k - 1)   # (k, B)
    eye = torch.eye(k, dtype=torch.bool, device=log_w.device)
    # (k_baseline, k_particle, B): row j = log_w with slot j → loo_mean_j
    replaced = torch.where(eye[:, :, None], loo_mean[:, None, :],
                           log_w[None, :, :])
    baseline = torch.logsumexp(replaced, dim=1) - logk        # (k, B)

    advantage = (bound[None] - baseline).detach()            # (k, B)
    score = torch.sum(advantage * log_q_pres, dim=0)          # (B,)

    loss = torch.mean(-bound - score)

    w_tilde = torch.softmax(log_w.detach(), dim=0)            # (k, B)
    metrics = {
        "iwae_bound": torch.mean(bound),
        "log_w_mean": torch.mean(log_w),
        "advantage_abs": torch.mean(torch.abs(advantage)),
        # effective sample size per image, 1 (degenerate) .. k (uniform)
        "ess": torch.mean(1.0 / torch.sum(w_tilde ** 2, dim=0)),
    }
    return loss, metrics


def log_importance_weights(outputs: AIROutputs, cfg, prior_success_prob,
                           what_weight=1.0) -> torch.Tensor:
    """Per-example ``log [p(x, z) / q(z | x)]`` at the sampled latents.

      log w = log p(x|z)
            + Σ_t pres_t · [log p(z_what_t) − log q(z_what_t|·)
                            + log p(z_where_t) − log q(z_where_t|·)]
            + log p(n) − log q(n|x)

    The probability of the sampled stopping pattern equals the count pmf
    at ``n = Σ_t pres_t`` under both q and the geometric prior.
    ``what_weight`` scales the z_what density-ratio term (the IWAE
    counterpart of ``kl_beta``).
    """
    from attend_infer_repeat_torch.models.modules import where_param_indices
    from attend_infer_repeat_torch.ops.distributions import (
        geometric_prior,
        normal_log_prob,
    )

    s = outputs.steps
    pres = s.pres                                             # (B, T)
    w_idx = list(where_param_indices(cfg))
    dev = pres.device
    z_w = s.z_where[..., w_idx]                               # reduced sample
    prior_loc = torch.tensor([cfg.where_prior_loc[i] for i in w_idx],
                             device=dev)
    prior_scale = torch.tensor([cfg.where_prior_scale[i] for i in w_idx],
                               device=dev)

    lw_where = torch.sum(
        normal_log_prob(z_w, prior_loc, prior_scale)
        - normal_log_prob(z_w, s.where_loc, s.where_scale), dim=-1)
    lw_what = torch.sum(
        normal_log_prob(s.z_what, 0.0, 1.0)
        - normal_log_prob(s.z_what, s.what_loc, s.what_scale), dim=-1)
    continuous = torch.sum(pres * (lw_where + what_weight * lw_what), dim=-1)

    t_steps = pres.shape[-1]
    n = torch.sum(pres, dim=-1).to(torch.int64)              # sampled count
    p_pmf = geometric_prior(prior_success_prob, t_steps, device=dev)
    eps = 1e-20
    log_q_n = torch.log(torch.gather(outputs.num_steps_pmf, -1,
                                     n[:, None])[:, 0] + eps)
    log_p_n = torch.log(p_pmf[n] + eps)

    return outputs.log_likelihood + continuous + log_p_n - log_q_n


def iwae_bound(log_weights: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Importance-weighted bound ``log (1/k) Σ_k exp(log_w_k)`` along ``dim``.

    Inputs must be ``log_importance_weights`` values (sampled-latent log
    weights), not analytic-KL ELBOs.
    """
    k = log_weights.shape[dim]
    return torch.logsumexp(log_weights, dim=dim) - math.log(float(k))
