"""The train and eval steps.

One train step does what the JAX package's jitted step does: produce the
minibatch on the device (grid synthesis from the digit bank, or a draw
from a resident dataset), run the model, form the surrogate (or VIMCO)
loss, take one gradient and apply the two-group RMSProp update.  The
spatial transformer's forward and backward are the hand-written kernels
on the card.

Step inputs.  The host computes what depends on the step index, in
float32 as before: the prior success probability and ``kl_beta`` of the
anneal schedules, and each optimizer group's learning rate of its update
count (``step_schedule``).  The step reads them as one schedule row on
the device, and draws from two generators made once and re-seeded for
each step.  Its device part (``_TrainStep.run``) reads nothing else from
the host and changes no host value, so one CUDA graph can capture it and
replay it; ``TrainState.step`` and the groups' counts stay host integers
that the caller advances.

RNG: torch has no ``fold_in``.  Step ``s`` of a state with base seed
``b`` draws its data from a generator seeded with ``seeds[0]`` and the
model's noise from one seeded with ``seeds[1]``, where
``seeds = numpy.random.SeedSequence((b, s)).generate_state(2, uint64)``;
both generators live on the model's device.  A step is thus a function of
``(state, step)`` alone, as ``fold_in(base_key, step)`` makes it in JAX.
``cfg.remat`` is the cell's business (``models/cell.py``).

``make_train_step`` runs eagerly (one step a call, and the host-streamed
path).  ``make_scan_train_step`` is the counterpart of ``jit(lax.scan)``:
on CUDA, K steps are one captured step replayed K times.

With a ``mesh`` (``parallel.make_mesh``) both keep the GSPMD meaning of
the JAX package: the result equals the single-device step.  Every rank
draws the global batch and the global noise from the step's generators,
keeps its rows, and averages the gradients and the metrics over the
ranks before the update.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
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
    GROUPS,
    Optimizer,
    TrainState,
    global_norm,
    param_group,
    prior_success_prob,
)

# the entries of a schedule row (``step_schedule``)
SCHEDULE = ("prior_success_prob", "kl_beta") + tuple(f"lr/{g}"
                                                     for g in GROUPS)


def step_seeds(base_seed: int, step: int, *words: int):
    """The ``(data, model)`` seeds of one step: ``SeedSequence((base,
    step, *words))``."""
    seeds = np.random.SeedSequence((base_seed, step, *words)).generate_state(
        2, np.uint64)
    return [int(s) for s in seeds]


def step_generators(base_seed: int, step: int, device):
    """``(data, model)`` generators of one step, seeded from ``(base, step)``."""
    return tuple(torch.Generator(device).manual_seed(s)
                 for s in step_seeds(base_seed, step))


def _l2_norm_sq(model: torch.nn.Module) -> torch.Tensor:
    """Σ‖θ‖² over model parameters only: the NVIL baseline is left out, so
    the L2 term sends no gradient into the baseline's own optimizer."""
    return sum(torch.sum(p * p) for name, p in model.named_parameters()
               if param_group(name) == "model")


def make_objective_loss_fn(config: Config, model: AIRModel, imgs,
                           generator, p_success, kl_beta, noise=None,
                           batch_mean=torch.mean):
    """Build ``loss_fn() → (loss, (metrics, outputs))`` for
    ``config.train.objective``.

    ``noise`` injects the forward's draws: one ``Noise`` for ``"elbo"``, a
    sequence of ``iwae_particles`` of them for ``"iwae"``; otherwise they
    come from ``generator``.  ``batch_mean`` takes the ``advantage_norm``
    statistic's means (a data-parallel step passes the global batch's).
    """
    tcfg = config.train

    if tcfg.objective == "iwae":
        def loss_fn():
            outs, lws, lqps = [], [], []
            for j in range(tcfg.iwae_particles):
                out = model(imgs, p_success, generator=generator,
                            noise=None if noise is None else noise[j])
                lws.append(log_importance_weights(
                    out, config.model, p_success, what_weight=kl_beta,
                    where_prior=model.where_prior()))
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
                advantage_norm=tcfg.advantage_norm,
                batch_mean=batch_mean)
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


def step_schedule(config: Config, opt: Optimizer, state: TrainState,
                  ahead: int = 0) -> torch.Tensor:
    """The schedule row of step ``state.step + ahead``: the ``SCHEDULE``
    values as a float32 CPU tensor, each as the host computes it."""
    step = state.step + ahead
    return torch.stack([
        prior_success_prob(config.prior, step),
        torch.as_tensor(kl_warmup(config, step), dtype=torch.float32),
        *(torch.tensor(opt.learning_rate(g, state.opt_state[g].count + ahead),
                       dtype=torch.float32) for g in GROUPS)])


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``, with no stream sync on CUDA (pinned
    memory, asynchronous copy)."""
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _TrainStep:
    """One train step's device part, the generators it draws from and
    the host values it reads.

    ``dp`` (``parallel.shard_map_step.DataParallel``) splits the step over
    the ranks of a mesh; None runs it on one device.
    """

    def __init__(self, config: Config, model: AIRModel, digit_bank=None,
                 device_data=None, dp=None):
        tcfg = config.train
        self.config, self.model, self.dp = config, model, dp
        self.device = dev = model.device
        self.bank = None
        if digit_bank is not None:
            self.bank = torch.as_tensor(digit_bank,
                                        dtype=torch.float32).to(dev)
        self.device_data = None
        if device_data is not None:
            if self.bank is not None:
                raise ValueError("pass digit_bank or device_data, not both")
            self.device_data = (
                _ordinary(torch.as_tensor(device_data[0],
                                          dtype=torch.float32).to(dev)),
                _ordinary(torch.as_tensor(device_data[1],
                                          dtype=torch.int32).to(dev)))
        self.batch_size = tcfg.batch_size if dp is None \
            else dp.batch_size(tcfg.batch_size)
        self.opt = Optimizer(tcfg, model)
        self.names, self.params = zip(*model.named_parameters())
        self.tops = sorted({n.split(".", 1)[0] for n in self.names})
        self.gens = (torch.Generator(dev), torch.Generator(dev))

    def check(self, state: TrainState) -> None:
        if state.model is not self.model:
            raise ValueError("state.model is not the model this step trains")

    def seed(self, state: TrainState, ahead: int = 0) -> None:
        """Seed the generators for step ``state.step + ahead``."""
        words = () if self.dp is None else self.dp.seed_words()
        for g, s in zip(self.gens, step_seeds(state.base_seed,
                                              state.step + ahead, *words)):
            g.manual_seed(s)

    def schedule(self, state: TrainState, ahead: int = 0) -> torch.Tensor:
        return step_schedule(self.config, self.opt, state, ahead)

    def state_tensors(self, state: TrainState):
        """Every tensor a step writes: parameters, ``nu``, ``trace``."""
        return [*self.params] + [t for st in state.opt_state.values()
                                 for t in (*st.nu, *st.trace)]

    def advance(self, state: TrainState, n: int) -> None:
        state.step += n
        self.opt.advance(state.opt_state, n)

    def _batch(self, batch):
        dev, g_data = self.device, self.gens[0]
        if batch is not None:
            # make_synth_fn returns inference tensors, which autograd
            # cannot save: a clone is an ordinary tensor
            return tuple(_ordinary(torch.as_tensor(t).to(dev))
                         for t in batch)
        if self.device_data is not None:
            ds_imgs, ds_nums = self.device_data
            idx = torch.randint(0, ds_imgs.shape[0], (self.batch_size,),
                                generator=g_data, device=dev)
            return ds_imgs[idx], ds_nums[idx]
        if self.bank is not None:
            with torch.no_grad():
                return synthesize_batch(self.bank, self.config.data,
                                        self.batch_size, g_data)
        raise ValueError("no data: build the step with digit_bank or "
                         "device_data, or pass batch=(imgs, nums)")

    def run(self, sched: torch.Tensor, opt_state, batch=None, noise=None
            ) -> Dict[str, torch.Tensor]:
        """The step on the device: batch, forward, gradient, update.

        ``sched`` is the step's schedule row on the device.  Writes the
        parameters and ``opt_state``'s tensors in place and returns the
        metrics as 0-d tensors.
        """
        tcfg, model, dp = self.config.train, self.model, self.dp
        p_success = sched[0]
        kl_beta = sched[1] if tcfg.kl_warmup_steps else 1.0
        imgs, nums = self._batch(batch)
        batch_mean = torch.mean
        if dp is not None:
            imgs, nums, noise = dp.split(model, self.config, imgs, nums,
                                         noise, self.gens[1])
            batch_mean = dp.batch_mean
        loss_fn = make_objective_loss_fn(
            self.config, model, imgs, self.gens[1], p_success, kl_beta,
            noise, batch_mean)
        loss, (metrics, outputs) = loss_fn()
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]

        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["count_accuracy"] = count_accuracy(outputs, nums)
        metrics["count_accuracy_mode"] = count_accuracy(outputs, nums,
                                                        use_mode=True)
        if dp is not None:
            grads = dp.mean(grads)
            metrics = dict(zip(metrics, dp.mean(list(metrics.values()))))
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
            if tcfg.log_grad_norms:
                for top in self.tops:
                    metrics[f"grad_norm/{top}"] = global_norm(
                        g for n, g in zip(self.names, grads)
                        if n.split(".", 1)[0] == top)
        self.opt.apply(dict(zip(self.names, grads)), opt_state,
                       {g: sched[2 + i] for i, g in enumerate(GROUPS)})
        metrics["prior_success_prob"] = p_success
        return metrics

    def eager(self, state: TrainState, batch=None, noise=None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step, run eagerly; advances ``state``."""
        self.check(state)
        self.seed(state)
        metrics = self.run(to_device(self.schedule(state), self.device),
                           state.opt_state, batch, noise)
        self.advance(state, 1)
        return state, metrics


def _global_batch(mesh):
    """GSPMD's split over ``mesh`` (None without one)."""
    if mesh is None:
        return None
    from attend_infer_repeat_torch.parallel.shard_map_step import (
        DataParallel)
    return DataParallel(mesh, global_batch=True)


def make_train_step(config: Config, model: AIRModel, digit_bank=None,
                    device_data=None, mesh=None) -> Callable:
    """Build ``step(state, batch=None, noise=None) → (state, metrics)``.

    The step trains ``model``, which must be ``state.model``.  With a
    ``digit_bank`` the batch is synthesized on the device from the step's
    data generator; with ``device_data`` (a whole ``(imgs, nums)`` dataset,
    moved to the device once) the minibatch is drawn uniformly with
    replacement from it; otherwise the caller passes ``batch=(imgs,
    nums)``.  ``noise`` injects the forward's draws (see
    ``make_objective_loss_fn``); with a ``mesh`` both are the global
    batch's.

    The step updates ``state`` in place (parameters, optimizer state,
    ``step + 1``) and returns it, with a dict of 0-d metric tensors: the
    loss, the surrogate's metrics, count accuracies, ``grad_norm`` (before
    clipping) and ``prior_success_prob``.  It runs eagerly, one step a
    call; ``make_scan_train_step`` runs K steps as a CUDA graph.
    """
    return _TrainStep(config, model, digit_bank, device_data,
                      _global_batch(mesh)).eager


def make_scan_train_step(config: Config, model: AIRModel, digit_bank,
                         k_steps: int, device_data=None, mesh=None
                         ) -> Callable:
    """``step(state) → (state, metrics)``: K train steps, metrics stacked.

    The counterpart of the JAX package's ``jit(lax.scan)`` over the step.
    On CUDA the step is captured once as a CUDA graph (at the first call,
    after warm-up steps that leave ``state`` as it was) and replayed K
    times a call, with the step's seeds and schedule row written before
    each replay; the K metric rows come back stacked (leading axis K).
    The results equal K calls of ``make_train_step``'s step.  A failed
    capture or replay raises.

    The graph holds the addresses of the model's parameters and of
    ``state.opt_state``'s tensors: a call with a state whose tensors are
    not those raises (a restore must copy in place, as
    ``train.checkpoint`` does).

    Runs the K steps eagerly, by design, on the CPU, inside
    ``utils.debug_mode`` (the counterpart of ``jax_disable_jit``) and
    with a ``mesh`` (the collectives are not captured).  Needs an
    on-device data source (``digit_bank`` or ``device_data``).
    """
    if digit_bank is None and device_data is None:
        raise ValueError("the K-step loop needs an on-device data source "
                         "(digit_bank or device_data)")
    dp = _global_batch(mesh)
    ts = _TrainStep(config, model, digit_bank, device_data, dp)
    graphed = None

    def scan(state: TrainState):
        nonlocal graphed
        from attend_infer_repeat_torch.utils import debug

        if ts.device.type == "cpu" or dp is not None or debug.active():
            rows = []
            for _ in range(k_steps):
                state, m = ts.eager(state)
                rows.append(m)
            return state, {k: torch.stack([m[k] for m in rows])
                           for k in rows[0]}
        ts.check(state)
        if graphed is None:
            graphed = StepGraph(ts, state, k_steps)
        return graphed.replay(state)

    return scan


@contextlib.contextmanager
def _no_host_sync():
    """Raise at any operation that waits for the card (a capture cannot
    wait), naming the forward operation behind a backward one."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():        # "a prototype feature"
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False):
            yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class StepGraph:
    """One train step captured as a CUDA graph, replayed K times a call.

    Static inputs, written before the replays of a call: the K schedule
    rows (one asynchronous copy from pinned memory) and a row index the
    graph reads and increments; the generators, registered with the graph
    and re-seeded before each replay.  The graph writes each step's
    metrics into row ``i`` of a ``(K, n_metrics)`` buffer.

    Capture runs the step's Python once and executes nothing, so the
    kernel wrappers' launch counts tick at capture: they are put back,
    and each replay adds the launches of one captured step.
    """

    WARMUP = 3

    def __init__(self, ts: _TrainStep, state: TrainState, k_steps: int):
        self.ts, self.k = ts, k_steps
        dev = ts.device
        self.tensors = ts.state_tensors(state)
        self.table = torch.zeros((k_steps, len(SCHEDULE)), device=dev)
        self.row = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.table.copy_(ts.schedule(state).expand(k_steps, -1))
        capture = None
        if dev.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            # the side stream torch.cuda.graph shares across the process:
            # warming up there too keeps one cuBLAS workspace for all graphs
            capture = torch.cuda.graph(self.graph)
        self._warm_up(state, None if capture is None
                      else capture.capture_stream)
        self.per_replay = self._capture(state, capture)

    def _warm_up(self, state: TrainState, stream) -> None:
        """A few steps on the capture's side stream, on the state's own
        tensors, which are put back after: they load the kernels, make
        the cuBLAS and autograd workspaces and run every host-side
        first-use call (a kernel's shared-memory opt-in) before capture."""
        ts, dev = self.ts, self.ts.device
        # no_grad: a clone tracked by autograd would make the parameters'
        # AccumulateGrad nodes on this stream, which capture may not sync
        with torch.no_grad():
            saved = [t.clone() for t in self.tensors]
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for i in range(self.WARMUP):
                ts.seed(state, i)
                if i == 0:
                    self.keys = list(ts.run(self.table[0], state.opt_state))
                    self.out = torch.zeros((self.k, len(self.keys)),
                                           device=dev)
                elif i < self.WARMUP - 1 or stream is None:
                    self._body(state)
                else:
                    with _no_host_sync():
                        self._body(state)
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
        with torch.no_grad():
            for t, s in zip(self.tensors, saved):
                t.copy_(s)

    def _capture(self, state: TrainState, capture):
        """Capture the step; returns the kernel launches of one replay."""
        from attend_infer_repeat_torch.ops import st_kernel

        for g in self.ts.gens:
            self.graph.register_generator_state(g)
        counts = st_kernel.launches, st_kernel.bwd_launches
        with capture:
            self._body(state)
        per_replay = (st_kernel.launches - counts[0],
                      st_kernel.bwd_launches - counts[1])
        st_kernel.launches, st_kernel.bwd_launches = counts
        return per_replay

    def _launch(self) -> None:
        self.graph.replay()

    def _body(self, state: TrainState) -> None:
        sched = torch.index_select(self.table, 0, self.row)[0]
        metrics = self.ts.run(sched, state.opt_state)
        if list(metrics) != self.keys:
            raise RuntimeError(f"the step's metrics changed: {list(metrics)}")
        self.out.index_copy_(0, self.row, torch.stack(
            list(metrics.values()))[None])
        self.row.add_(1)

    def replay(self, state: TrainState):
        """K steps from ``state``; advances it and returns the metric rows."""
        from attend_infer_repeat_torch.ops import st_kernel

        ts = self.ts
        now = ts.state_tensors(state)
        if len(now) != len(self.tensors) or any(
                a is not b for a, b in zip(now, self.tensors)):
            raise ValueError("the state's tensors are not the ones the graph "
                             "was captured with (restore in place)")
        rows = torch.stack([ts.schedule(state, i) for i in range(self.k)])
        self.table.copy_(to_device(rows, ts.device))
        self.row.zero_()
        for i in range(self.k):
            ts.seed(state, i)
            self._launch()
        st_kernel.launches += self.k * self.per_replay[0]
        st_kernel.bwd_launches += self.k * self.per_replay[1]
        ts.advance(state, self.k)
        out = self.out.clone()
        return state, {k: out[:, j] for j, k in enumerate(self.keys)}


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
