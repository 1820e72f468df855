"""Serving layer: batched amortized inference and generation.

The functions returned here run under ``torch.inference_mode()`` on the
model's device and return the same keys and batch-major shapes as the
JAX package's serving functions.  Each draws its noise from the caller's
generator, then runs its forward through a ``utils.graphs.GraphCache``,
the counterpart of the JAX package's jitted function: on CUDA a CUDA
graph captured at the first call of each batch (or tile) shape and
replayed a call, eager where ``utils.graphs.eager`` holds.  With a
``mesh`` (``parallel.make_mesh``) the noise is drawn for the whole batch
as one device would draw it; each rank runs its rows of the batch and
all-gathers the outputs, so every rank gets the whole result, equal to
the single-device call.  On CUDA that, the all-gather too, is one CUDA
graph per batch shape, which every rank must call alike
(``utils.graphs``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from attend_infer_repeat_torch.configs import Config
from attend_infer_repeat_torch.models.air import AIRModel, Noise
from attend_infer_repeat_torch.parallel.sharding import (
    constrain_batch,
    gather_batch,
)
from attend_infer_repeat_torch.utils import graphs
from attend_infer_repeat_torch.utils.profiling import span


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
    the batch instead.  ``None`` runs the batch in one pass.  A tiled
    batch replays one graph of the tile's shape once per chunk, as
    ``lax.scan`` runs one program per chunk, so that memory stays at one
    tile's.  With a ``mesh`` each rank runs its rows in one pass (a
    ``tile`` only sets how the noise is drawn).
    """
    p_success = torch.tensor(config.prior.final_success_prob,
                             dtype=torch.float32, device=model.device)

    def forward(imgs, noise, p):
        """The batch's outputs from its noise: this rank's rows, gathered,
        with a mesh."""
        if mesh is not None:
            imgs = constrain_batch(imgs, mesh)
            noise = tuple(constrain_batch(a, mesh, dim=1) for a in noise)
        out = model(imgs, p, noise=noise)
        out = {
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
        if mesh is None:
            return out
        return {k: gather_batch(v, mesh) for k, v in out.items()}

    cache = graphs.GraphCache(lambda held, *inputs: forward(*inputs))

    def draw(batch, generator):
        """The forward's noise for ``batch``: one stream, or one per tile."""
        with span("serve.noise"):
            if tile is None or batch <= tile:
                return model.sample_noise(batch, generator)
            gens = _chunk_generators(generator, batch // tile, model.device)
            return tuple(torch.cat(parts, dim=1) for parts in
                         zip(*(model.sample_noise(tile, g) for g in gens)))

    @torch.inference_mode()
    def infer(imgs: torch.Tensor, generator: torch.Generator | None = None,
              noise: Noise | None = None) -> Dict[str, torch.Tensor]:
        with span("serve.infer"):
            return _infer(imgs, generator, noise)

    def _infer(imgs, generator, noise):
        batch = imgs.shape[0]
        tiled = tile is not None and batch > tile
        if tiled and batch % tile:
            raise ValueError(f"batch {batch} not divisible by tile {tile}")
        if noise is None:
            noise = draw(batch, generator)
        if mesh is not None or not tiled:
            return cache(model, imgs, tuple(noise), p_success)
        imgs = imgs.to(model.device)
        outs = {}
        for c in range(batch // tile):
            sl = slice(c * tile, (c + 1) * tile)
            out = cache.replay(model, imgs[sl],
                               tuple(a[:, sl] for a in noise), p_success)
            for k, v in out.items():
                if k not in outs:
                    outs[k] = v.new_empty((batch,) + tuple(v.shape[1:]))
                outs[k][sl] = v
        return outs

    infer.graphs = cache
    return infer


def make_generate_fn(config: Config, model: AIRModel,
                     success_prob: Optional[float] = None,
                     mesh=None) -> Callable:
    """``(batch, generator=None, noise=None) → imgs`` — sample scenes.

    ``success_prob`` sets the geometric count prior the scenes are drawn
    from.  The default (``None`` → 1.0, uniform over 0..max_steps) matches
    the data's uniform count distribution; the trained model's annealed
    prior (``config.prior.final_success_prob``) puts almost all mass on
    empty scenes, so callers opt into it explicitly.  One graph per batch
    renders the scenes from the noise drawn first.  With a ``mesh`` each
    rank draws the whole batch's noise, renders its rows and all-gathers
    the scenes (in the graph on CUDA).
    """
    p_success = 1.0 if success_prob is None else success_prob

    def render(noise):
        if mesh is None:
            return model.generate(noise[0].shape[0], p_success, noise=noise)
        rows = tuple(constrain_batch(a, mesh) for a in noise)
        return gather_batch(model.generate(rows[0].shape[0], p_success,
                                           noise=rows), mesh)

    cache = graphs.GraphCache(lambda held, noise: render(noise))

    @torch.inference_mode()
    def generate(batch: int, generator: torch.Generator | None = None,
                 noise=None) -> torch.Tensor:
        if noise is None:
            noise = model.generate_noise(batch, p_success, generator)
        return cache(model, tuple(noise))

    generate.graphs = cache
    return generate
