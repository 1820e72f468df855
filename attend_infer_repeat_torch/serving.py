"""Serving layer: batched amortized inference and generation.

The functions returned here run under ``torch.inference_mode()`` on the
model's device and return the same keys and batch-major shapes as the
JAX package's serving functions.  On CUDA each is a CUDA graph
(``utils.graphs``), the counterpart of the JAX package's jitted
function: captured at the first call of each batch (or tile) shape and
replayed a call, with the noise drawn from the caller's generator before
the replay, as the eager call draws it, so the results, and the
generator's state after the call, equal the eager call's.  They run
eagerly on the CPU and inside ``utils.debug_mode``.  With a ``mesh``
(``parallel.make_mesh``) the noise is drawn for the whole batch as one
device would draw it; each rank runs its rows of the batch and
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
    the batch instead.  ``None`` runs the batch in one pass.  On CUDA a
    tiled batch replays one graph of the tile's shape once per chunk, as
    ``lax.scan`` runs one program per chunk, so that memory stays at one
    tile's.  With a ``mesh`` each rank runs its rows in one pass (a
    ``tile`` only sets how the noise is drawn).
    """
    p_success = config.prior.final_success_prob
    p_device = torch.tensor(p_success, dtype=torch.float32,
                            device=model.device)

    def _one(imgs, generator, noise, p=p_success):
        out = model(imgs, p, generator=generator, noise=noise)
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

    def forward(imgs, noise, p):
        """The batch's outputs from its noise: this rank's rows, gathered,
        with a mesh."""
        if mesh is None:
            return _one(imgs, None, noise, p)
        out = _one(constrain_batch(imgs, mesh), None,
                   tuple(constrain_batch(a, mesh, dim=1) for a in noise), p)
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
        eager = graphs.eager(model.device)
        if eager and mesh is None and not tiled:
            return _one(imgs.to(model.device), generator, noise)
        if noise is None:
            noise = draw(batch, generator)
        if mesh is not None or not tiled:
            if eager:
                return forward(imgs.to(model.device), tuple(noise),
                               p_success)
            return cache(model, imgs, tuple(noise), p_device)
        imgs = imgs.to(model.device)
        outs = {}
        for c in range(batch // tile):
            sl = slice(c * tile, (c + 1) * tile)
            chunk = imgs[sl], tuple(a[:, sl] for a in noise)
            out = (_one(chunk[0], None, chunk[1]) if eager
                   else cache.replay(model, *chunk, p_device))
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
    empty scenes, so callers opt into it explicitly.  On CUDA one graph
    per batch renders the scenes from noise drawn before the replay.  With
    a ``mesh`` each rank draws the whole batch's noise, renders its rows
    and all-gathers the scenes (in the graph on CUDA).
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
        eager = graphs.eager(model.device)
        if eager and mesh is None:
            return model.generate(batch, p_success, generator=generator,
                                  noise=noise)
        if noise is None:
            noise = model.generate_noise(batch, p_success, generator)
        if eager:
            return render(tuple(noise))
        return cache(model, tuple(noise))

    generate.graphs = cache
    return generate
