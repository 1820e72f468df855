"""Serving layer: batched amortized inference and generation.

The functions returned here run under ``torch.inference_mode()`` on the
model's device and return the same keys and batch-major shapes as the
JAX package's serving functions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from attend_infer_repeat_torch.configs import Config
from attend_infer_repeat_torch.models.air import AIRModel, Noise


def _chunk_generators(generator: torch.Generator | None, n: int,
                      device: torch.device):
    """One independent generator stream per chunk, seeded from ``generator``."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device if generator is not None
                          else device).tolist()
    return [torch.Generator(device).manual_seed(s) for s in seeds]


def make_infer_fn(config: Config, model: AIRModel,
                  tile: Optional[int] = None) -> Callable:
    """``(imgs, generator=None, noise=None) → dict`` — posterior inference.

    Returns the serving subset of ``AIROutputs``: reconstruction, per-object
    pose/appearance posteriors, presence and count prediction.

    ``tile`` runs a wider batch in chunks of ``tile`` (which must divide
    it), each with its own generator stream; injected ``noise`` (the
    forward's ``(T, B, ...)`` tensors for the whole batch) is sliced along
    the batch instead.  ``None`` runs the batch in one pass.
    """
    p_success = config.prior.final_success_prob

    def _one(imgs, generator, noise):
        out = model(imgs, p_success, generator=generator, noise=noise)
        return {
            "canvas": out.canvas,
            "elbo": out.elbo,
            "z_where": out.steps.z_where,
            "where_loc": out.steps.where_loc,
            "where_scale": out.steps.where_scale,
            "what_loc": out.steps.what_loc,
            "what_scale": out.steps.what_scale,
            "presence": out.steps.pres,
            "presence_prob": out.steps.pres_prob,
            "num_steps_pmf": out.num_steps_pmf,
            "predicted_steps": out.predicted_steps,
            "mode_steps": out.mode_steps,
        }

    @torch.inference_mode()
    def infer(imgs: torch.Tensor, generator: torch.Generator | None = None,
              noise: Noise | None = None) -> Dict[str, torch.Tensor]:
        imgs = imgs.to(model.device)
        batch = imgs.shape[0]
        if tile is None or batch <= tile:
            return _one(imgs, generator, noise)
        if batch % tile:
            raise ValueError(f"batch {batch} not divisible by tile {tile}")
        n = batch // tile
        gens = (_chunk_generators(generator, n, model.device)
                if noise is None else [None] * n)
        outs = []
        for c in range(n):
            sl = slice(c * tile, (c + 1) * tile)
            chunk_noise = (None if noise is None
                           else tuple(a[:, sl] for a in noise))
            outs.append(_one(imgs[sl], gens[c], chunk_noise))
        return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}

    return infer


def make_generate_fn(config: Config, model: AIRModel,
                     success_prob: Optional[float] = None) -> Callable:
    """``(batch, generator=None, noise=None) → imgs`` — sample scenes.

    ``success_prob`` sets the geometric count prior the scenes are drawn
    from.  The default (``None`` → 1.0, uniform over 0..max_steps) matches
    the data's uniform count distribution; the trained model's annealed
    prior (``config.prior.final_success_prob``) puts almost all mass on
    empty scenes, so callers opt into it explicitly.
    """
    p_success = 1.0 if success_prob is None else success_prob

    @torch.inference_mode()
    def generate(batch: int, generator: torch.Generator | None = None,
                 noise=None) -> torch.Tensor:
        return model.generate(batch, p_success, generator=generator,
                              noise=noise)

    return generate
