"""Distribution math for AIR: step-count distributions and KL divergences.

Closed-form pmfs and KLs, no sampling, so the count-KL term of the ELBO
is exact.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from attend_infer_repeat_torch.ops.math import clip_preserve

_EPS = 1e-15


def geometric_prior(step_success_prob, n_steps: int,
                    device=None) -> torch.Tensor:
    """Truncated geometric pmf over counts ``0..n_steps``.

    ``pmf(k) ∝ q**k`` with ``q = step_success_prob``, normalized in
    log-space for stability at ``q → 1`` and ``q → 0``.  Returns shape
    ``(n_steps + 1,)``; differentiable w.r.t. ``q``.
    """
    q = torch.as_tensor(step_success_prob, dtype=torch.float32,
                        device=device)
    q = torch.clamp(q, _EPS, 1.0 - _EPS)
    ks = torch.arange(n_steps + 1, dtype=torch.float32, device=q.device)
    log_pmf = ks * torch.log(q)
    return torch.exp(log_pmf - torch.logsumexp(log_pmf, dim=-1))


def presence_pmf(presence_prob: torch.Tensor) -> torch.Tensor:
    """Count pmf of a monotone chain of per-step presence probabilities.

    ``presence_prob (..., T)`` holds the effective probability of step
    ``t`` given the chain so far; ``pmf(k) = (prod_{t<=k} p_t)(1 − p_{k+1})``
    and ``pmf(T) = prod_t p_t``.  Returns ``(..., T + 1)``.
    """
    p = presence_prob
    # the running product written out: torch.cumprod's backward checks the
    # input for zeros on the host, which a captured step cannot do
    cp = [p[..., 0]]
    for t in range(1, p.shape[-1]):
        cp.append(cp[-1] * p[..., t])
    cp = torch.stack(cp, dim=-1)
    ones = torch.ones_like(p[..., :1])
    cp_ext = torch.cat([ones, cp], dim=-1)
    p_next = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    return cp_ext * (1.0 - p_next)


@dataclasses.dataclass(frozen=True)
class NumStepsDistribution:
    """Posterior over object counts from per-step presence probabilities."""

    presence_prob: torch.Tensor  # (..., T)

    @property
    def n_steps(self) -> int:
        return self.presence_prob.shape[-1]

    def pmf(self) -> torch.Tensor:
        return presence_pmf(self.presence_prob)

    def log_pmf(self) -> torch.Tensor:
        return torch.log(clip_preserve(self.pmf(), _EPS, 1.0))

    def expectation(self) -> torch.Tensor:
        ks = torch.arange(self.n_steps + 1, dtype=torch.float32,
                          device=self.presence_prob.device)
        return torch.sum(self.pmf() * ks, dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.pmf(), dim=-1)

    def sample(self, generator: torch.Generator | None = None,
               u: torch.Tensor | None = None) -> torch.Tensor:
        """Ancestral sample of the count: each Bernoulli in the chain.

        ``u`` injects the uniforms; otherwise they come from ``generator``.
        """
        p = self.presence_prob
        if u is None:
            u = torch.rand(p.shape, generator=generator, device=p.device)
        pres = (u < p).to(torch.float32)
        return torch.sum(torch.cumprod(pres, dim=-1), dim=-1)


def tabular_kl(q: torch.Tensor, p: torch.Tensor,
               eps: float = _EPS) -> torch.Tensor:
    """Exact KL(q ‖ p) between tabular pmfs over the last axis.

    Both pmfs pass through the straight-through clip, so zero entries stay
    finite without blocking gradients.
    """
    q = clip_preserve(q, eps, 1.0)
    p = clip_preserve(p, eps, 1.0)
    return torch.sum(q * (torch.log(q) - torch.log(p)), dim=-1)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def normal_kl(loc_q, scale_q, loc_p, scale_p) -> torch.Tensor:
    """Elementwise KL( N(loc_q, scale_q²) ‖ N(loc_p, scale_p²) )."""
    var_ratio = (scale_q / scale_p) ** 2
    mean_term = ((loc_q - loc_p) / scale_p) ** 2
    return 0.5 * (var_ratio + mean_term - 1.0 - torch.log(var_ratio))


def normal_log_prob(x, loc, scale) -> torch.Tensor:
    """Elementwise log N(x; loc, scale²)."""
    z = (x - loc) / scale
    return -0.5 * (z * z + math.log(2.0 * math.pi)) - _log(scale)


def bernoulli_log_prob(x, prob, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise log Bernoulli(x; prob) with straight-through clipping."""
    p = clip_preserve(prob, eps, 1.0 - eps)
    return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)


def logit_relaxed_bernoulli_sample(logits: torch.Tensor, u: torch.Tensor,
                                   temperature: float,
                                   eps: float = 1e-6) -> torch.Tensor:
    """A sample ``y`` of the logit-space relaxed Bernoulli (the binary
    Concrete in logit space): ``y = (logits + log u − log(1 − u)) / τ``
    for uniforms ``u``, clipped to ``[eps, 1 − eps]`` so that the logistic
    noise stays finite.  ``sigmoid(y)`` is the relaxed presence."""
    u = torch.clamp(u, eps, 1.0 - eps)
    return (logits + torch.log(u) - torch.log1p(-u)) / temperature


def logit_relaxed_bernoulli_log_prob(y: torch.Tensor, logits,
                                     temperature: float) -> torch.Tensor:
    """``log q(y) = log τ − τy + logits − 2·softplus(logits − τy)``, the
    density of that sample (``torch.distributions.relaxed_bernoulli.
    LogitRelaxedBernoulli(τ, logits=logits).log_prob(y)``)."""
    diff = logits - temperature * y
    return math.log(temperature) + diff \
        - 2.0 * torch.nn.functional.softplus(diff)
