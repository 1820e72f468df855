"""Train state, the two-group optimizer, and the prior anneal schedule.

The JAX package runs one ``optax.multi_transform`` over two parameter
groups: the model, and the NVIL ``baseline`` subtree.  ``Optimizer``
writes that transform out by hand, because ``torch.optim.RMSprop`` is
another algorithm (decay 0.99, eps outside the square root, the learning
rate applied after momentum).  Per group, as optax 0.2.6 composes it:

    [clip_by_global_norm(c)]          model group only, norm over its grads
    nu    = 0.1 g² + 0.9 nu           scale_by_rms(decay=0.9, eps=1e-8,
    u     = g / sqrt(nu + 1e-8)         eps_in_sqrt=True, initial_scale=0)
    u     = −lr(count) · u            scale_by_learning_rate
    trace = u + momentum · trace      trace(momentum)
    θ     = θ + trace

``lr`` is ``cosine_decay_schedule(lr, lr_decay_steps, alpha=lr_end_factor)``
of the model group's own update count when ``lr_decay_steps`` is set,
else constant; the baseline's lr is constant.

RNG: the state keeps a base seed; each step seeds its own generators from
``(base_seed, step)`` (``train.step.step_generators``), so resuming needs
only those two numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from attend_infer_repeat_torch.configs import (
    Config,
    PriorAnnealConfig,
    SequenceConfig,
    SpaceConfig,
    TrainConfig,
)
from attend_infer_repeat_torch.models.air import AIRModel
from attend_infer_repeat_torch.models.space import SpaceModel
from attend_infer_repeat_torch.models.sqair import SQAIRModel
from attend_infer_repeat_torch.ops.math import exp_anneal, linear_anneal

RMS_DECAY, RMS_EPS = 0.9, 1e-8
GROUPS = ("model", "baseline")


def param_group(name: str) -> str:
    """``"baseline"`` for the NVIL baseline's parameters, else ``"model"``."""
    return "baseline" if name.split(".", 1)[0] == "baseline" else "model"


@dataclasses.dataclass
class GroupState:
    """One group's optimizer state, tensors in the group's parameter order."""

    count: int                    # updates taken: the lr schedule's step
    nu: List[torch.Tensor]        # EMA of squared gradients
    trace: List[torch.Tensor]     # momentum


@dataclasses.dataclass
class TrainState:
    """Everything a training step reads and writes.

    ``model`` holds the parameters; a step updates them, and
    ``opt_state``, in place.
    """

    step: int
    model: AIRModel
    opt_state: Dict[str, GroupState]
    base_seed: int


class Optimizer:
    """The JAX package's ``make_optimizer`` as in-place tensor updates:
    RMSProp(lr, momentum) on the model group, with the optional global
    norm clip and cosine decay; RMSProp at a constant lr on the baseline.

    ``apply`` runs under ``torch.no_grad()`` and writes the parameters
    and the state in place: that takes the place of JAX's donated buffers
    (the previous values are not kept).  Nothing rebinds a parameter,
    ``nu`` or ``trace`` tensor, so a captured step keeps its addresses.
    """

    def __init__(self, cfg: TrainConfig, model: torch.nn.Module):
        self.cfg = cfg
        self.names: Dict[str, List[str]] = {g: [] for g in GROUPS}
        self.params: Dict[str, List[torch.Tensor]] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            self.names[param_group(name)].append(name)
            self.params[param_group(name)].append(p)

    def init(self) -> Dict[str, GroupState]:
        return {g: GroupState(0, [torch.zeros_like(p) for p in ps],
                              [torch.zeros_like(p) for p in ps])
                for g, ps in self.params.items()}

    def learning_rate(self, group: str, count: int) -> float:
        """The group's lr at update ``count``, rounded as optax's f32."""
        cfg = self.cfg
        if group == "baseline":
            return cfg.baseline_learning_rate
        if not cfg.lr_decay_steps:
            return cfg.learning_rate
        steps = float(cfg.lr_decay_steps)
        c = torch.tensor(float(min(count, cfg.lr_decay_steps)),
                         dtype=torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / steps))
        decayed = (1 - cfg.lr_end_factor) * cosine + cfg.lr_end_factor
        return float(cfg.learning_rate * decayed)

    def update(self, grads: Dict[str, torch.Tensor],
               state: Dict[str, GroupState]) -> None:
        """One update of every parameter from ``grads`` (by parameter
        name) at each group's lr for its ``count``; advances the counts."""
        dev = next(p for ps in self.params.values() for p in ps).device
        self.apply(grads, state, {
            g: torch.tensor(self.learning_rate(g, state[g].count),
                            dtype=torch.float32, device=dev)
            for g in GROUPS})
        self.advance(state, 1)

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor],
              state: Dict[str, GroupState],
              lr: Dict[str, torch.Tensor]) -> None:
        """The update's device part: every parameter, ``nu`` and ``trace``
        written in place at the learning rates ``lr`` (0-d float32 tensors
        on the parameters' device, by group).  Reads no host state, so a
        CUDA graph can capture it; the caller advances the counts."""
        clip = self.cfg.grad_clip_norm
        for group, ps in self.params.items():
            if not ps:
                continue
            st = state[group]
            gs = [grads[n] for n in self.names[group]]
            if group == "model" and clip is not None:
                norm = global_norm(gs)
                gs = [torch.where(norm < clip, g, (g / norm) * clip)
                      for g in gs]
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(sq, 1 - RMS_DECAY)
            torch._foreach_mul_(st.nu, RMS_DECAY)
            torch._foreach_add_(st.nu, sq)
            u = torch._foreach_add(st.nu, RMS_EPS)
            torch._foreach_rsqrt_(u)
            torch._foreach_mul_(u, gs)
            torch._foreach_mul_(u, torch.neg(lr[group]))
            torch._foreach_mul_(st.trace, self.cfg.momentum)
            torch._foreach_add_(st.trace, u)
            torch._foreach_add_(ps, st.trace)

    def advance(self, state: Dict[str, GroupState], n: int) -> None:
        """Count ``n`` updates of every group that has parameters."""
        for group, ps in self.params.items():
            if ps:
                state[group].count += n


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over a list of tensors (optax ``global_norm``)."""
    norms = torch._foreach_norm(list(tensors))
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


def create_train_state(config: Config, seed: int | None = None,
                       device=None,
                       sequence: SequenceConfig | None = None,
                       space: SpaceConfig | None = None) -> TrainState:
    """A fresh model (flax-style init from ``seed``) and optimizer state.

    ``seed`` defaults to ``config.train.seed``; the model runs on CUDA
    unless ``device="cpu"``.  With ``sequence`` the model is a
    ``SQAIRModel`` of ``config.model`` over such sequences, with ``space``
    a ``SpaceModel`` of ``config.model.img_size`` scenes; either has no
    NVIL baseline (one ``model`` group).
    """
    seed = config.train.seed if seed is None else seed
    if (sequence is not None or space is not None) \
            and config.train.use_baseline:
        raise ValueError("SQAIR and SPACE train without the NVIL baseline "
                         "(train.use_baseline=False)")
    if sequence is not None and space is not None:
        raise ValueError("pass sequence or space, not both")
    if space is not None:
        model = SpaceModel(config.model, space, device=device, seed=seed)
    elif sequence is not None:
        model = SQAIRModel(config.model, sequence, device=device, seed=seed)
    else:
        model = AIRModel(config.model,
                         use_baseline=config.train.use_baseline,
                         device=device, seed=seed)
    return TrainState(step=0, model=model,
                      opt_state=Optimizer(config.train, model).init(),
                      base_seed=seed)


def prior_success_prob(cfg: PriorAnnealConfig, step) -> torch.Tensor:
    """Annealed geometric-prior success probability at ``step`` (f32, 0-d)."""
    fn = exp_anneal if cfg.schedule == "exp" else linear_anneal
    return fn(step, cfg.init_success_prob, cfg.final_success_prob,
              cfg.anneal_start, cfg.anneal_start + cfg.anneal_steps)


def param_count(model: torch.nn.Module) -> Dict[str, int]:
    """Parameter counts per top-level module, and their total."""
    counts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        counts[top] = counts.get(top, 0) + p.numel()
    counts["total"] = sum(counts.values())
    return counts
