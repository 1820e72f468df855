"""Primitive numeric helpers: straight-through clip, anneals, masked mean,
and seeded generators."""

from __future__ import annotations

import numpy as np
import torch


def seeded_generator(device, *words: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integers ``words``.

    torch has no ``fold_in``: ``numpy.random.SeedSequence`` mixes the words
    into one seed, so ``seeded_generator(dev, seed, step, i)`` plays the part
    of ``fold_in(fold_in(key(seed), step), i)``.
    """
    seed = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(seed))


def clip_preserve(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clip values to ``[lo, hi]`` while passing gradients through unclipped.

    Forward value is ``clamp(x)``, backward is the identity.  Keeps ``log``
    of near-zero probabilities finite without killing the gradient.
    """
    return x + (torch.clamp(x, lo, hi) - x).detach()


def linear_anneal(step, start_value, end_value, start_step, end_step):
    """Linear schedule from ``start_value`` to ``end_value``.

    Constant before ``start_step`` and after ``end_step``.
    """
    step = torch.as_tensor(step, dtype=torch.float32)
    span = max(float(end_step) - float(start_step), 1.0)
    frac = torch.clamp((step - float(start_step)) / span, 0.0, 1.0)
    return start_value + (end_value - start_value) * frac


def exp_anneal(step, start_value, end_value, start_step, end_step):
    """Geometric schedule: linear in log-space; both endpoints positive."""
    log_frac = linear_anneal(step, 0.0, 1.0, start_step, end_step)
    log_start = torch.log(torch.as_tensor(start_value, dtype=torch.float32))
    log_end = torch.log(torch.as_tensor(end_value, dtype=torch.float32))
    return torch.exp(log_start + (log_end - log_start) * log_frac)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                eps: float = 1e-8) -> torch.Tensor:
    """Mean of ``x`` over entries where ``mask`` is nonzero."""
    mask = mask.to(x.dtype)
    if dim is None:
        total, count = torch.sum(x * mask), torch.sum(mask)
    else:
        total, count = torch.sum(x * mask, dim=dim), torch.sum(mask, dim=dim)
    return total / torch.clamp(count, min=eps)
