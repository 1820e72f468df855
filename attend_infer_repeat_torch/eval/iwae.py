"""Importance-weighted ELBO evaluation.

``k`` posterior particles per image, combined with ``logsumexp − log k``
over the true log importance weights ``log p(x, z_k) − log q(z_k | x)``
at each particle's sampled latents (``estimator.log_importance_weights``).
The particles run along the batch axis: one forward at batch ``k·B``
(the JAX package ``vmap``s the forward over ``k`` keys).  Its draws are
taken first; the forward runs through a ``utils.graphs.GraphCache``: one
CUDA graph per batch shape on the card, eager where
``utils.graphs.eager`` holds.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from attend_infer_repeat_torch.configs import Config
from attend_infer_repeat_torch.models.estimator import (
    iwae_bound,
    log_importance_weights,
)
from attend_infer_repeat_torch.train.state import prior_success_prob
from attend_infer_repeat_torch.utils import graphs


def make_iwae_eval_step(config: Config, model, n_particles: int = 5
                        ) -> Callable:
    """``(state, imgs, generator=None, noise=None) → dict`` of 0-d tensors.

    Runs ``model`` (its own config, e.g. with ``explore_eps=None``) on the
    parameters of ``state.model``.  Returns the analytic single-sample
    ELBO mean (the training metric), the k-particle IWAE bound and
    ``iwae_gap``, their difference.  ``noise`` injects one ``Noise`` per
    particle; otherwise the k·B draws come from ``generator``.
    """
    k = n_particles

    def bound(params, imgs, p_success, noise):
        batch = imgs.shape[0]
        out = torch.func.functional_call(
            model, params, (imgs.repeat(k, 1, 1), p_success),
            {"noise": noise})
        log_w = log_importance_weights(
            out, config.model, p_success,
            where_prior=model.where_prior()).reshape(k, batch)
        elbos = out.elbo.reshape(k, batch)
        iw = iwae_bound(log_w, dim=0)                        # (B,)
        return {
            "iwae_bound": torch.mean(iw),
            "elbo": torch.mean(elbos),
            "log_w_mean": torch.mean(log_w),
            "iwae_gap": torch.mean(iw) - torch.mean(elbos),
        }

    cache = graphs.GraphCache(bound)

    @torch.no_grad()
    def eval_fn(state, imgs, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence] = None):
        p_success = prior_success_prob(config.prior, state.step)
        params = dict(state.model.named_parameters())
        imgs = torch.as_tensor(imgs)
        if noise is None:
            noise = model.sample_noise(k * imgs.shape[0], generator)
        else:
            # particle j is rows j·B .. (j+1)·B − 1 of the wide batch
            noise = tuple(torch.cat(parts, dim=1) for parts in zip(*noise))
        out = cache(params, imgs, p_success, noise)
        return dict(out, n_particles=torch.tensor(float(k)))

    eval_fn.graphs = cache
    return eval_fn
