"""The train and eval steps.

One train step does what the JAX package's jitted step does: produce the
minibatch on the device (grid synthesis from the digit bank, or a draw
from a resident dataset), run the model, form the surrogate (or VIMCO)
loss, take one gradient and apply the two-group RMSProp update.  PyTorch
runs it eagerly; the spatial transformer's forward and backward are the
hand-written kernels on the card.

RNG: torch has no ``fold_in``.  Step ``s`` of a state with base seed
``b`` draws its data from a generator seeded with ``seeds[0]`` and the
model's noise from one seeded with ``seeds[1]``, where
``seeds = numpy.random.SeedSequence((b, s)).generate_state(2, uint64)``;
both generators live on the model's device.  A step is thus a function of
``(state, step)`` alone, as ``fold_in(base_key, step)`` makes it in JAX.
``cfg.remat`` is the cell's business (``models/cell.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from attend_infer_repeat_torch.configs import Config
from attend_infer_repeat_torch.data.synth import synthesize_batch
from attend_infer_repeat_torch.models.air import AIRModel
from attend_infer_repeat_torch.models.estimator import (
    count_accuracy,
    log_importance_weights,
    presence_log_prob,
    surrogate_loss,
    vimco_surrogate_loss,
)
from attend_infer_repeat_torch.train.state import (
    Optimizer,
    TrainState,
    global_norm,
    param_group,
    prior_success_prob,
)


def step_generators(base_seed: int, step: int, device):
    """``(data, model)`` generators of one step, seeded from ``(base, step)``."""
    seeds = np.random.SeedSequence((base_seed, step)).generate_state(
        2, np.uint64)
    return tuple(torch.Generator(device).manual_seed(int(s)) for s in seeds)


def _l2_norm_sq(model: torch.nn.Module) -> torch.Tensor:
    """Σ‖θ‖² over model parameters only: the NVIL baseline is left out, so
    the L2 term sends no gradient into the baseline's own optimizer."""
    return sum(torch.sum(p * p) for name, p in model.named_parameters()
               if param_group(name) == "model")


def make_objective_loss_fn(config: Config, model: AIRModel, imgs,
                           generator, p_success, kl_beta, noise=None):
    """Build ``loss_fn() → (loss, (metrics, outputs))`` for
    ``config.train.objective``.

    ``noise`` injects the forward's draws: one ``Noise`` for ``"elbo"``, a
    sequence of ``iwae_particles`` of them for ``"iwae"``; otherwise they
    come from ``generator``.
    """
    tcfg = config.train

    if tcfg.objective == "iwae":
        def loss_fn():
            outs, lws, lqps = [], [], []
            for j in range(tcfg.iwae_particles):
                out = model(imgs, p_success, generator=generator,
                            noise=None if noise is None else noise[j])
                lws.append(log_importance_weights(
                    out, config.model, p_success, what_weight=kl_beta))
                lqps.append(torch.sum(presence_log_prob(out), dim=-1))
                outs.append(out)
            loss, metrics = vimco_surrogate_loss(torch.stack(lws),
                                                 torch.stack(lqps))
            if tcfg.l2_weight:
                loss = loss + tcfg.l2_weight * _l2_norm_sq(model)

            def mean(field):
                return torch.mean(torch.stack(
                    [getattr(o, field) for o in outs]))
            # particle 0 carries the reporting surface; the ELBO
            # decomposition is averaged over particles
            metrics.update(
                {f: mean(f) for f in ("elbo", "log_likelihood", "kl_what",
                                      "kl_where", "kl_steps",
                                      "expected_steps", "predicted_steps")},
                baseline_mse=torch.zeros((), device=imgs.device))
            return loss, (metrics, outs[0])
    else:
        def loss_fn():
            outputs = model(imgs, p_success, generator=generator, noise=noise)
            loss, metrics = surrogate_loss(
                outputs,
                l2_params_norm=_l2_norm_sq(model) if tcfg.l2_weight else 0.0,
                l2_weight=tcfg.l2_weight,
                kl_beta=kl_beta,
                advantage_norm=tcfg.advantage_norm)
            return loss, (metrics, outputs)

    return loss_fn


def _ordinary(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.is_inference() else t


def kl_warmup(config: Config, step: int):
    """``kl_beta`` at ``step``: a linear ramp 0 → 1 over ``kl_warmup_steps``."""
    warm = config.train.kl_warmup_steps
    if not warm:
        return 1.0
    return torch.clamp(torch.tensor(float(step)) / warm, 0.0, 1.0)


def make_train_step(config: Config, model: AIRModel, digit_bank=None,
                    device_data=None) -> Callable:
    """Build ``step(state, batch=None, noise=None) → (state, metrics)``.

    The step trains ``model``, which must be ``state.model``.  With a
    ``digit_bank`` the batch is synthesized on the device from the step's
    data generator; with ``device_data`` (a whole ``(imgs, nums)`` dataset,
    moved to the device once) the minibatch is drawn uniformly with
    replacement from it; otherwise the caller passes ``batch=(imgs,
    nums)``.  ``noise`` injects the forward's draws (see
    ``make_objective_loss_fn``).

    The step updates ``state`` in place (parameters, optimizer state,
    ``step + 1``) and returns it, with a dict of 0-d metric tensors: the
    loss, the surrogate's metrics, count accuracies, ``grad_norm`` (before
    clipping) and ``prior_success_prob``.
    """
    tcfg = config.train
    dev = model.device
    bank = None
    if digit_bank is not None:
        bank = torch.as_tensor(digit_bank, dtype=torch.float32).to(dev)
    if device_data is not None:
        if bank is not None:
            raise ValueError("pass digit_bank or device_data, not both")
        ds_imgs = _ordinary(torch.as_tensor(device_data[0],
                                            dtype=torch.float32).to(dev))
        ds_nums = _ordinary(torch.as_tensor(device_data[1],
                                            dtype=torch.int32).to(dev))
    opt = Optimizer(tcfg, model)
    names, params = zip(*model.named_parameters())
    tops = sorted({n.split(".", 1)[0] for n in names})

    def step(state: TrainState, batch=None, noise=None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("state.model is not the model this step trains")
        g_data, g_model = step_generators(state.base_seed, state.step, dev)
        p_success = prior_success_prob(config.prior, state.step)

        if batch is not None:
            # make_synth_fn returns inference tensors, which autograd
            # cannot save: a clone is an ordinary tensor
            imgs, nums = (_ordinary(torch.as_tensor(t).to(dev))
                          for t in batch)
        elif device_data is not None:
            idx = torch.randint(0, ds_imgs.shape[0], (tcfg.batch_size,),
                                generator=g_data, device=dev)
            imgs, nums = ds_imgs[idx], ds_nums[idx]
        elif bank is not None:
            with torch.no_grad():
                imgs, nums = synthesize_batch(bank, config.data,
                                              tcfg.batch_size, g_data)
        else:
            raise ValueError("no data: build the step with digit_bank or "
                             "device_data, or pass batch=(imgs, nums)")

        loss_fn = make_objective_loss_fn(
            config, model, imgs, g_model, p_success,
            kl_warmup(config, state.step), noise)
        loss, (metrics, outputs) = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]

        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["count_accuracy"] = count_accuracy(outputs, nums)
        metrics["count_accuracy_mode"] = count_accuracy(outputs, nums,
                                                        use_mode=True)
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
            if tcfg.log_grad_norms:
                for top in tops:
                    metrics[f"grad_norm/{top}"] = global_norm(
                        g for n, g in zip(names, grads)
                        if n.split(".", 1)[0] == top)
        opt.update(dict(zip(names, grads)), state.opt_state)
        metrics["prior_success_prob"] = p_success
        state.step += 1
        return state, metrics

    return step


def make_scan_train_step(config: Config, model: AIRModel, digit_bank,
                         k_steps: int, device_data=None) -> Callable:
    """``step(state) → (state, metrics)``: K train steps, metrics stacked.

    A plain loop of K single steps (each seeds its own generators from
    its step index), so it equals K calls of ``make_train_step``'s step.
    Needs an on-device data source (``digit_bank`` or ``device_data``).
    """
    if digit_bank is None and device_data is None:
        raise ValueError("the K-step loop needs an on-device data source "
                         "(digit_bank or device_data)")
    step1 = make_train_step(config, model, digit_bank=digit_bank,
                            device_data=device_data)

    def scan(state: TrainState):
        rows = []
        for _ in range(k_steps):
            state, m = step1(state)
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return scan


def make_eval_step(config: Config, model: AIRModel) -> Callable:
    """``eval(state, imgs, nums, generator=None, noise=None) → (metrics,
    outputs)`` on a fixed batch, with no parameter change.

    Runs the parameters of ``state.model`` in a model built from
    ``model``'s own config with ``explore_eps=None`` (the explore floor is
    a training device); the step index only selects the annealed prior.
    """
    eval_model = model.with_config(
        dataclasses.replace(model.cfg, explore_eps=None))

    @torch.no_grad()
    def eval_fn(state: TrainState, imgs, nums,
                generator: Optional[torch.Generator] = None, noise=None):
        p_success = prior_success_prob(config.prior, state.step)
        outputs = torch.func.functional_call(
            eval_model, dict(state.model.named_parameters()),
            (imgs.to(eval_model.device), p_success),
            {"generator": generator, "noise": noise})
        _, metrics = surrogate_loss(outputs)
        nums = torch.as_tensor(nums).to(eval_model.device)
        metrics["count_accuracy"] = count_accuracy(outputs, nums)
        metrics["count_accuracy_mode"] = count_accuracy(outputs, nums,
                                                        use_mode=True)
        return metrics, outputs

    return eval_fn
