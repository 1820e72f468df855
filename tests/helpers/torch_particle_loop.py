"""The ``iwae`` objective as the port ran it before its particles rode the
batch: k forwards of the model at batch B in a Python loop.  The reference
that the wide forward (``train.step.make_objective_loss_fn``) is held to,
on the CPU (``tests/test_torch_train.py``) and on the card
(``tests/test_torch_particles_cuda.py``).  Imports no JAX.
"""

import torch

from attend_infer_repeat_torch.models.estimator import (
    log_importance_weights,
    presence_log_prob,
    vimco_surrogate_loss,
)


def looped_iwae_loss(config, model, imgs, generator, p_success, kl_beta,
                     noise=None):
    """The ``iwae`` objective as k forwards at batch B, each particle's
    draws taken in turn: the reference for the wide forward.  Returns the
    loss, the reported means and particle 0's outputs."""
    outs, lws, lqps = [], [], []
    for j in range(config.train.iwae_particles):
        out = model(imgs, p_success, generator=generator,
                    noise=None if noise is None else noise[j])
        lws.append(log_importance_weights(
            out, config.model, p_success, what_weight=kl_beta,
            where_prior=model.where_prior()))
        lqps.append(torch.sum(presence_log_prob(out), dim=-1))
        outs.append(out)
    loss, metrics = vimco_surrogate_loss(torch.stack(lws), torch.stack(lqps))
    metrics.update({f: torch.mean(torch.stack([getattr(o, f) for o in outs]))
                    for f in ("elbo", "log_likelihood", "kl_what",
                              "kl_where", "kl_steps", "expected_steps",
                              "predicted_steps")})
    return loss, metrics, outs[0]
