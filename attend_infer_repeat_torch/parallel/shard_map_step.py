"""Explicit-collective data-parallel train step.

The JAX package's ``shard_map`` step spells the SPMD program out: each
device synthesizes its own shard of the global batch (keyed by its mesh
index), computes local gradients and averages them with ``pmean`` over
the ``data`` axis; parameters and optimizer state stay replicated and
every device applies the same averaged update.  Here each rank is a
process: it seeds its generators from ``(base_seed, step, rank)``,
synthesizes ``batch_size / world`` canvases and averages gradients and
metrics with one all-reduce.

``DataParallel`` is how a train step splits over the ranks, for this
step and for the GSPMD-meaning ``make_train_step(..., mesh=)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from attend_infer_repeat_torch.configs import Config
from attend_infer_repeat_torch.parallel.sharding import (
    all_reduce_mean,
    constrain_batch,
)
from attend_infer_repeat_torch.train.step import _TrainStep


@dataclasses.dataclass
class DataParallel:
    """How one train step splits over the ranks of ``mesh``.

    ``global_batch``: every rank draws the global batch and the global
    noise from the step's generators and keeps its rows, and the
    ``advantage_norm`` statistic is the global batch's (GSPMD's meaning:
    the result equals the single-device step).  Otherwise each rank's
    batch is its own, drawn from generators seeded with its rank too
    (``per_rank_seeds``) or handed in.  Gradients and metrics are averaged
    over the ranks before the update either way.
    """

    mesh: object
    global_batch: bool
    per_rank_seeds: bool = False

    def batch_size(self, global_size: int) -> int:
        """The batch a rank draws."""
        world = self.mesh.size()
        if global_size % world:
            raise ValueError(f"batch_size {global_size} not divisible by "
                             f"mesh size {world}")
        return global_size if self.global_batch else global_size // world

    def seed_words(self):
        return (self.mesh.get_local_rank(),) if self.per_rank_seeds else ()

    def split(self, model, config: Config, imgs, nums, noise, generator):
        """This rank's rows of the batch and of the forward's noise."""
        if not self.global_batch:
            return imgs, nums, noise
        if noise is None:
            batch = imgs.shape[0]
            if config.train.objective == "iwae":
                noise = [model.sample_noise(batch, generator)
                         for _ in range(config.train.iwae_particles)]
            else:
                noise = model.sample_noise(batch, generator)

        def rows(n):                      # noise is (T, B, ...)
            return tuple(constrain_batch(a, self.mesh, dim=1) for a in n)
        noise = ([rows(n) for n in noise] if isinstance(noise, list)
                 else rows(noise))
        return (constrain_batch(imgs, self.mesh),
                constrain_batch(nums, self.mesh), noise)

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the batch ``advantage_norm`` reads."""
        if not self.global_batch:
            return torch.mean(t)
        return all_reduce_mean([torch.mean(t)], self.mesh)[0]

    def mean(self, tensors):
        return all_reduce_mean(list(tensors), self.mesh)


def make_shardmap_train_step(config: Config, model, digit_bank, mesh,
                             external_batch: bool = False) -> Callable:
    """``step(state) → (state, metrics)``, each rank on its own shard.

    Each rank synthesizes ``batch_size / world`` canvases from generators
    seeded with ``(base_seed, step, rank)``, takes its gradient and
    averages gradients and metrics over the ranks; every rank then
    applies the same update to its replica of ``state``.

    With ``external_batch=True`` the step is ``step(state, (imgs, nums),
    noise=None)``: the batch is the whole batch, replicated on every rank,
    and the model's generator is the plain step's (seeded from
    ``(base_seed, step)``), so every rank computes the same full-batch
    step, the average is exact, and the result equals the plain step on
    that batch.  (Sharded data would draw per-rank noise: the same
    objective, other draws, so only the replicated layout compares.)

    With ``advantage_norm`` the statistic is the rank's own batch's (the
    single-device step takes the global batch's): the same estimator, a
    slightly different step size per rank.  Both objectives are supported.
    """
    dp = DataParallel(mesh, global_batch=False,
                      per_rank_seeds=not external_batch)
    dp.batch_size(config.train.batch_size)             # checks it divides
    ts = _TrainStep(config, model, digit_bank, None, dp)
    if external_batch:
        def step(state, batch, noise=None):
            return ts.eager(state, batch, noise)
    else:
        def step(state):
            return ts.eager(state)
    return step
