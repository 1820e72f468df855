"""Serving layer: batched amortized inference and generation.

The functions returned here run under ``torch.inference_mode()`` on the
model's device and return the same keys and batch-major shapes as the
JAX package's serving functions.  With a ``mesh``
(``parallel.make_mesh``) each rank runs its rows of the batch, with the
noise drawn for the whole batch as one device would draw it, and every
rank gets the whole result: it equals the single-device call.
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
                  tile: Optional[int] = None, mesh=None) -> Callable:
    """``(imgs, generator=None, noise=None) → dict`` — posterior inference.

    Returns the serving subset of ``AIROutputs``: reconstruction, per-object
    pose/appearance posteriors, presence and count prediction.

    ``tile`` runs a wider batch in chunks of ``tile`` (which must divide
    it), each with its own generator stream; injected ``noise`` (the
    forward's ``(T, B, ...)`` tensors for the whole batch) is sliced along
    the batch instead.  ``None`` runs the batch in one pass.  With a
    ``mesh`` each rank runs its rows in one pass.
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

    def draw(batch, generator):
        """The forward's noise for ``batch``: one stream, or one per tile."""
        if tile is None or batch <= tile:
            return model.sample_noise(batch, generator)
        gens = _chunk_generators(generator, batch // tile, model.device)
        return tuple(torch.cat(parts, dim=1) for parts in
                     zip(*(model.sample_noise(tile, g) for g in gens)))

    @torch.inference_mode()
    def infer(imgs: torch.Tensor, generator: torch.Generator | None = None,
              noise: Noise | None = None) -> Dict[str, torch.Tensor]:
        imgs = imgs.to(model.device)
        batch = imgs.shape[0]
        tiled = tile is not None and batch > tile
        if tiled and batch % tile:
            raise ValueError(f"batch {batch} not divisible by tile {tile}")
        if mesh is None and not tiled:
            return _one(imgs, generator, noise)
        if noise is None:
            noise = draw(batch, generator)
        if mesh is not None:
            from attend_infer_repeat_torch.parallel.sharding import (
                constrain_batch, gather_batch)
            out = _one(constrain_batch(imgs, mesh), None,
                       tuple(constrain_batch(a, mesh, dim=1) for a in noise))
            return {k: gather_batch(v, mesh) for k, v in out.items()}
        outs = []
        for c in range(batch // tile):
            sl = slice(c * tile, (c + 1) * tile)
            outs.append(_one(imgs[sl], None, tuple(a[:, sl] for a in noise)))
        return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}

    return infer


def make_generate_fn(config: Config, model: AIRModel,
                     success_prob: Optional[float] = None,
                     mesh=None) -> Callable:
    """``(batch, generator=None, noise=None) → imgs`` — sample scenes.

    ``success_prob`` sets the geometric count prior the scenes are drawn
    from.  The default (``None`` → 1.0, uniform over 0..max_steps) matches
    the data's uniform count distribution; the trained model's annealed
    prior (``config.prior.final_success_prob``) puts almost all mass on
    empty scenes, so callers opt into it explicitly.  With a ``mesh`` each
    rank draws the whole batch's noise and renders its rows.
    """
    p_success = 1.0 if success_prob is None else success_prob

    @torch.inference_mode()
    def generate(batch: int, generator: torch.Generator | None = None,
                 noise=None) -> torch.Tensor:
        if mesh is None:
            return model.generate(batch, p_success, generator=generator,
                                  noise=noise)
        from attend_infer_repeat_torch.parallel.sharding import (
            constrain_batch, gather_batch)
        if noise is None:
            noise = model.generate_noise(batch, p_success, generator)
        rows = tuple(constrain_batch(a, mesh) for a in noise)
        return gather_batch(model.generate(rows[0].shape[0], p_success,
                                           noise=rows), mesh)

    return generate
