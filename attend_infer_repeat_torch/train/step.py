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

Both run through ``StepGraph``, the counterpart of the JAX package's
jitted programs: ``make_train_step`` one step a call (one ``StepGraph``
per data source: on-device data, a caller's batch, injected noise),
``make_scan_train_step`` (``jit(lax.scan)``) K steps a call.  On CUDA a
``StepGraph`` captures its step as a CUDA graph at its first call and
replays it; where ``utils.graphs.eager`` holds (the CPU,
``utils.debug_mode``) it runs the same step eagerly, with the same
schedule rows and seeds.  ``make_eval_step`` runs one forward a call
through a ``utils.graphs.GraphCache``, with the annealed prior an input.

With a ``mesh`` (``parallel.make_mesh``) both keep the GSPMD meaning of
the JAX package: the result equals the single-device step.  Every rank
draws the global batch and the global noise from the step's generators,
keeps its rows, and averages the gradients and the metrics over the
ranks before the update.  On CUDA those collectives are captured with
the step, as GSPMD puts them inside the jitted program.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional

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
from attend_infer_repeat_torch.utils import graphs
from attend_infer_repeat_torch.utils.profiling import span

# the entries of a schedule row (``step_schedule``)
SCHEDULE = ("prior_success_prob", "kl_beta") + tuple(f"lr/{g}"
                                                     for g in GROUPS)


#: The objective's Python since the process started: ``steps`` (calls of
#: a ``make_objective_loss_fn`` loss) and ``forwards`` (the model forwards
#: they ran).  A graph's warm-ups and capture count like eager steps and a
#: replay runs no Python, so ``forwards / steps`` is a step's forwards.
objective_counts: collections.Counter = collections.Counter()


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

    Under ``"iwae"`` the k particles run along the batch: each one's draws
    are taken in turn from ``generator`` (or injected), joined along the
    batch axis, and one forward at batch k·B gives particle j the rows
    j·B … (j+1)·B − 1.  Each bf16 layer gives each particle what k
    forwards at batch B give (``models.modules.dense``): the same outputs,
    and weight gradients rounded particle by particle.
    Particle 0's rows carry the reporting surface; the ELBO decomposition
    is averaged over particles and batch.

    Each call of ``loss_fn`` adds to ``objective_counts`` one step and
    one model forward.
    """
    tcfg = config.train

    if tcfg.objective == "iwae":
        k = tcfg.iwae_particles

        def loss_fn():
            batch = imgs.shape[0]
            draws = noise if noise is not None else [
                model.sample_noise(batch, generator) for _ in range(k)]
            out = model(imgs.repeat(k, 1, 1), p_success,
                        noise=tuple(torch.cat(parts, dim=1)
                                    for parts in zip(*draws)),
                        particles=k)
            lws = log_importance_weights(
                out, config.model, p_success, what_weight=kl_beta,
                where_prior=model.where_prior()).reshape(k, batch)
            lqps = torch.sum(presence_log_prob(out),
                             dim=-1).reshape(k, batch)
            objective_counts.update(steps=1, forwards=1)
            loss, metrics = vimco_surrogate_loss(lws, lqps)
            if tcfg.l2_weight:
                loss = loss + tcfg.l2_weight * _l2_norm_sq(model)
            metrics.update(
                {f: torch.mean(getattr(out, f).reshape(k, batch))
                 for f in ("elbo", "log_likelihood", "kl_what", "kl_where",
                           "kl_steps", "expected_steps", "predicted_steps")},
                baseline_mse=torch.zeros((), device=imgs.device))
            return loss, (metrics, out.head(batch))
    else:
        def loss_fn():
            outputs = model(imgs, p_success, generator=generator, noise=noise)
            objective_counts.update(steps=1, forwards=1)
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
    clipping) and ``prior_success_prob``.

    Each data source (on-device data, a ``batch``, injected ``noise``,
    each of one shape) has its ``StepGraph`` with K = 1, which a given
    batch and noise are copied into (a host batch from pinned memory).
    A captured graph holds the addresses of the parameters and of
    ``state.opt_state``'s tensors: a state whose tensors are not those
    raises.  With a ``mesh`` the graph holds the step's collectives too
    (the gradient and metric all-reduce, and ``advantage_norm``'s batch
    statistic): every rank must call the step alike (``utils.graphs``).
    """
    return _graphed_step(_TrainStep(config, model, digit_bank, device_data,
                                    _global_batch(mesh)))


def _graphed_step(ts: _TrainStep) -> Callable:
    """``step(state, batch=None, noise=None)``: ``ts`` through one
    ``StepGraph`` (K = 1) per data source; ``step.graphs`` maps each data
    source's signature to its ``StepGraph``."""
    cache = {}

    def step(state: TrainState, batch=None, noise=None):
        ts.check(state)
        if batch is not None:
            batch = tuple(torch.as_tensor(t) for t in batch)
        key = graphs.signature((batch, noise))
        graph = cache.get(key)
        if graph is None:
            graph = cache[key] = StepGraph(ts, state, 1, batch, noise)
        state, rows = graph.replay(state, batch, noise)
        return state, {k: v[0] for k, v in rows.items()}

    step.graphs = cache
    return step


def make_scan_train_step(config: Config, model: AIRModel, digit_bank,
                         k_steps: int, device_data=None, mesh=None
                         ) -> Callable:
    """``step(state) → (state, metrics)``: K train steps, metrics stacked.

    The counterpart of the JAX package's ``jit(lax.scan)`` over the step:
    one ``StepGraph`` that runs the step K times a call, with the step's
    seeds and schedule row written before each; the K metric rows come
    back stacked (leading axis K).  The results equal K calls of
    ``make_train_step``'s step.  A failed capture or replay raises.

    A captured graph holds the addresses of the model's parameters and
    of ``state.opt_state``'s tensors: a call with a state whose tensors
    are not those raises (a restore must copy in place, as
    ``train.checkpoint`` does).  With a ``mesh`` the graph holds each
    step's collectives too.  Needs an on-device data source
    (``digit_bank`` or ``device_data``).  ``scan.graphs`` holds the
    ``StepGraph`` once built (at the first call), under K.
    """
    if digit_bank is None and device_data is None:
        raise ValueError("the K-step loop needs an on-device data source "
                         "(digit_bank or device_data)")
    ts = _TrainStep(config, model, digit_bank, device_data,
                    _global_batch(mesh))

    def scan(state: TrainState):
        ts.check(state)
        if not scan.graphs:
            scan.graphs[k_steps] = StepGraph(ts, state, k_steps)
        return scan.graphs[k_steps].replay(state)

    scan.graphs = {}
    return scan


class StepGraph:
    """One train step run K times a call: captured as a CUDA graph
    (``utils.graphs.Graph``) at the first call outside
    ``utils.graphs.eager``, and replayed; where ``eager`` holds, the
    same step runs eagerly on the state passed in.

    Static inputs, written before the steps of a call: the K schedule
    rows (one asynchronous copy from pinned memory) and a row index the
    step reads and increments; a given batch and injected noise
    (``batch``, ``noise``: their static copies); the generators,
    registered with the graph and re-seeded before each step.  Each step
    writes its metrics into row ``i`` of a ``(K, n_metrics)`` buffer.
    The warm-up steps run on the state's own tensors, which are put back
    after.  ``graph``: the captured ``Graph``, None until then.
    """

    def __init__(self, ts: _TrainStep, state: TrainState, k_steps: int,
                 batch=None, noise=None):
        self.ts, self.k = ts, k_steps
        dev = ts.device
        self.table = torch.zeros((k_steps, len(SCHEDULE)), device=dev)
        self.row = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.table.copy_(ts.schedule(state).expand(k_steps, -1))
        self.inputs = graphs.static_like((batch, noise), dev)
        self.keys, self.out = None, None
        self.graph, self.held = None, None

    def _capture(self, state: TrainState) -> None:
        """Warm up and capture the step on ``state``'s tensors, which the
        graph then holds."""
        ts = self.ts
        tensors = ts.state_tensors(state)
        self.held = graphs.addresses(tensors)
        self.row.zero_()                    # where eager steps left it

        def prepare(i):
            ts.seed(state, i)
            self.row.zero_()

        self.graph = graphs.Graph(lambda: self._body(state), ts.device,
                                  state=[*tensors, self.row],
                                  generators=ts.gens, prepare=prepare)

    def _body(self, state: TrainState) -> None:
        sched = torch.index_select(self.table, 0, self.row)[0]
        metrics = self.ts.run(sched, state.opt_state, *self.inputs)
        if self.keys is None:               # the first step run
            self.keys = list(metrics)
            self.out = torch.zeros((self.k, len(self.keys)),
                                   device=self.ts.device)
        elif list(metrics) != self.keys:
            raise RuntimeError(f"the step's metrics changed: {list(metrics)}")
        self.out.index_copy_(0, self.row, torch.stack(
            list(metrics.values()))[None])
        self.row.add_(1)

    def replay(self, state: TrainState, batch=None, noise=None):
        """K steps from ``state`` (on ``batch`` and ``noise``, of the
        signature given at construction); advances it and returns the
        metric rows."""
        ts = self.ts
        eager = graphs.eager(ts.device)
        if not eager and self.graph is None:
            # before the steps' seeds: the warm-ups re-seed the generators
            self._capture(state)
        with span("train.steps"):
            with span("train.prepare"):
                if not eager:
                    graphs.check_held(self.held, ts.state_tensors(state),
                                      "state's tensors")
                graphs.fill(self.inputs, (batch, noise))
                rows = torch.stack([ts.schedule(state, i)
                                    for i in range(self.k)])
                self.table.copy_(to_device(rows, ts.device))
                self.row.zero_()
            for i in range(self.k):
                with span("train.seed"):
                    ts.seed(state, i)
                if eager:
                    self._body(state)
                else:
                    self.graph.launch()
            ts.advance(state, self.k)
            out = self.out.clone()
        return state, {k: out[:, j] for j, k in enumerate(self.keys)}


def _eval_forward(eval_model: AIRModel, params, imgs, nums, p_success,
                  noise):
    """The eval step's device part: ``(metrics, outputs)``."""
    outputs = torch.func.functional_call(
        eval_model, params, (imgs, p_success), {"noise": noise})
    _, metrics = surrogate_loss(outputs)
    metrics["count_accuracy"] = count_accuracy(outputs, nums)
    metrics["count_accuracy_mode"] = count_accuracy(outputs, nums,
                                                    use_mode=True)
    return metrics, outputs


def make_eval_step(config: Config, model: AIRModel) -> Callable:
    """``eval(state, imgs, nums, generator=None, noise=None) → (metrics,
    outputs)`` on a fixed batch, with no parameter change.

    Runs the parameters of ``state.model`` in a model built from
    ``model``'s own config with ``explore_eps=None`` (the explore floor is
    a training device); the step index only selects the annealed prior.

    The forward runs through a ``GraphCache``, one graph per batch
    shape: the noise is drawn from ``generator`` first, and the prior's
    success probability is an input.  The results are copies that a later
    call leaves alone.  A graph holds the addresses of ``state.model``'s
    parameters: a state whose parameters are not those raises.
    """
    eval_model = model.with_config(
        dataclasses.replace(model.cfg, explore_eps=None))
    cache = graphs.GraphCache(
        lambda params, *inputs: _eval_forward(eval_model, params, *inputs))

    @torch.no_grad()
    def eval_fn(state: TrainState, imgs, nums,
                generator: Optional[torch.Generator] = None, noise=None):
        p_success = prior_success_prob(config.prior, state.step)
        params = dict(state.model.named_parameters())
        nums = torch.as_tensor(nums)
        if noise is None:
            noise = eval_model.sample_noise(imgs.shape[0], generator)
        return cache(params, imgs, nums, p_success, tuple(noise))

    eval_fn.graphs = cache
    return eval_fn
