"""The training step in plain PyTorch: data, forward, the gradient of the
configuration's objective and the two-group RMSProp update.

Step ``s`` of a run with base seed ``b`` draws its canvases from a device
generator seeded with ``w[0]`` and the forward's noise from one seeded
with ``w[1]``, ``w = SeedSequence((b, s)).generate_state(2, uint64)``: the
seeding the trained program documents, so that the reference sees the
same batch and noise as the program's step ``s``.  The objective
``elbo`` runs one forward a step and takes the NVIL loss; ``iwae`` runs
``iwae_particles`` forwards of the same batch, drawing each one's noise in
turn from the step's model generator, and takes the VIMCO loss of their
log weights.

Per step: the prior's success probability annealed in log space from
``init_success_prob`` to ``final_success_prob`` over
``[anneal_start, anneal_start + anneal_steps]``; ``kl_beta = min(s /
kl_warmup_steps, 1)``.  The update, per group (the NVIL ``baseline`` and
the rest), as optax composes ``clip_by_global_norm`` (model group only),
``scale_by_rms(0.9, 1e-8, eps_in_sqrt)``, the learning rate (cosine
decay to ``lr_end_factor`` over ``lr_decay_steps`` for the model group)
and ``trace(momentum)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from air_bench.reference import synth
from air_bench.reference.air import (Model, log_weight, nvil_loss,
                                     presence_log_prob, sample_noise,
                                     vimco_loss)
from air_bench.reference.precision import Precision

RMS_DECAY, RMS_EPS = 0.9, 1e-8
#: What a step reports, under the program's names, by objective.
#: ``elbo``: the surrogate loss, the ELBO's batch mean and its KL terms
#: (the model group's forward), the baseline's regression (the baseline
#: group's) and the whole gradient's norm before clipping.  ``iwae``: the
#: VIMCO loss, the bound's batch mean, the ELBO and its KL terms (means
#: over the particles and the batch) and the gradient's norm; there is no
#: baseline.
READINGS = {
    "elbo": ("loss", "elbo", "kl_what", "kl_where", "kl_steps",
             "baseline_mse", "grad_norm"),
    "iwae": ("loss", "iwae_bound", "elbo", "kl_what", "kl_where",
             "kl_steps", "grad_norm"),
}
_TERMS = ("elbo", "kl_what", "kl_where", "kl_steps")


def readings(cfg: dict) -> tuple:
    """The readings a step of ``cfg`` reports."""
    return READINGS[cfg["train"]["objective"]]


def particles(cfg: dict) -> int:
    """Forwards of the model a train step of ``cfg`` runs on each image."""
    t = cfg["train"]
    return t["iwae_particles"] if t["objective"] == "iwae" else 1


def step_seeds(base_seed: int, step: int):
    s = np.random.SeedSequence((base_seed, step)).generate_state(2, np.uint64)
    return [int(v) for v in s]


def prior_success_prob(prior: dict, step: int) -> torch.Tensor:
    start, end = prior["anneal_start"], prior["anneal_start"] + \
        prior["anneal_steps"]
    frac = torch.clamp((torch.tensor(float(step)) - float(start))
                       / max(float(end) - float(start), 1.0), 0.0, 1.0)
    a, b = prior["init_success_prob"], prior["final_success_prob"]
    if prior["schedule"] == "linear":
        return a + (b - a) * frac
    la = torch.log(torch.tensor(a, dtype=torch.float32))
    lb = torch.log(torch.tensor(b, dtype=torch.float32))
    return torch.exp(la + (lb - la) * frac)


def kl_beta(train: dict, step: int):
    warm = train["kl_warmup_steps"]
    if not warm:
        return 1.0
    return torch.clamp(torch.tensor(float(step)) / warm, 0.0, 1.0)


def learning_rate(train: dict, group: str, count: int) -> float:
    if group == "baseline":
        return train["baseline_learning_rate"]
    decay = train["lr_decay_steps"]
    if not decay:
        return train["learning_rate"]
    c = torch.tensor(float(min(count, decay)), dtype=torch.float32)
    cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay)))
    end = train["lr_end_factor"]
    return float(train["learning_rate"] * ((1 - end) * cosine + end))


def group_of(name: str) -> str:
    return "baseline" if name.split(".", 1)[0] == "baseline" else "model"


def global_norm(ts) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.double() * t.double())
                          for t in ts)).float()


class Trainer:
    """The reference's own parameters and optimizer state, stepped from
    step 0 of base seed ``base_seed``.  ``groups``: the groups that the
    update moves (both, unless a fault is planted)."""

    groups = ("model", "baseline")

    def __init__(self, cfg: dict, params: dict, bank: torch.Tensor,
                 base_seed: int, prec: Precision | None = None):
        self.cfg, self.bank, self.base_seed = cfg, bank, base_seed
        self.readings = readings(cfg)
        self.prec = prec or Precision()
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.trace = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step_no = 0
        self.counts = {"model": 0, "baseline": 0}

    def batch(self, step: int):
        """The step's canvases and each forward's noise, in the order the
        program draws them."""
        dev = self.bank.device
        g_data, g_model = (torch.Generator(dev).manual_seed(s)
                           for s in step_seeds(self.base_seed, step))
        imgs, nums = synth.synthesize(self.bank, self.cfg["data"],
                                      self.cfg["train"]["batch_size"],
                                      g_data, self.prec)
        noises = [sample_noise(self.cfg["model"], imgs.shape[0], g_model, dev)
                  for _ in range(particles(self.cfg))]
        return imgs, nums, noises

    def loss(self, model: Model, outs: list, p_success, beta):
        """``(loss, terms)`` of the configuration's objective."""
        if self.cfg["train"]["objective"] != "iwae":
            return nvil_loss(outs[0], beta)
        log_w = torch.stack([log_weight(o, model.m, model.where_prior,
                                        p_success, beta) for o in outs])
        log_q = torch.stack([torch.sum(presence_log_prob(o["steps"]), -1)
                             for o in outs])
        loss, terms = vimco_loss(log_w, log_q)
        terms.update({k: torch.mean(torch.stack([o[k] for o in outs]))
                      .detach() for k in _TERMS})
        return loss, terms

    def step(self):
        """One step; returns ``(readings, grads)``: the step's readings
        as floats and the gradient before clipping, by parameter name."""
        cfg, s = self.cfg, self.step_no
        dev = self.bank.device
        imgs, _, noises = self.batch(s)
        model = Model(cfg, self.params, self.prec)
        p_success = prior_success_prob(cfg["prior"], s).to(dev)
        outs = [model.forward(imgs, p_success, noise) for noise in noises]
        beta = kl_beta(cfg["train"], s)
        loss, terms = self.loss(model, outs, p_success,
                                beta.to(dev) if torch.is_tensor(beta)
                                else beta)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        norm = global_norm(grads.values())
        self.update(grads)
        self.step_no += 1
        got = dict(terms, loss=loss.detach(), grad_norm=norm)
        return {k: float(got[k]) for k in self.readings}, grads

    def follow(self, steps: int) -> dict:
        """``{reading: [...]}`` of the next ``steps`` steps, for each of
        the configuration's readings."""
        got = {k: [] for k in self.readings}
        for _ in range(steps):
            readings, _ = self.step()
            for k, v in readings.items():
                got[k].append(v)
        return got

    @torch.no_grad()
    def update(self, grads: dict) -> None:
        tcfg = self.cfg["train"]
        clip = tcfg["grad_clip_norm"]
        for group in self.groups:
            names = [n for n in self.params if group_of(n) == group]
            if not names:
                continue
            gs = [grads[n] for n in names]
            if group == "model" and clip is not None:
                norm = global_norm(gs)
                gs = [torch.where(norm < clip, g, (g / norm) * clip)
                      for g in gs]
            lr = torch.tensor(learning_rate(tcfg, group, self.counts[group]),
                              dtype=torch.float32)
            for n, g in zip(names, gs):
                nu, tr, p = self.nu[n], self.trace[n], self.params[n]
                nu.mul_(RMS_DECAY).add_(g * g * (1 - RMS_DECAY))
                u = torch.rsqrt(nu + RMS_EPS) * g * (-lr.to(g.device))
                tr.mul_(tcfg["momentum"]).add_(u)
                p.add_(tr)
            self.counts[group] += 1
