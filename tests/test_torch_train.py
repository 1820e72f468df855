"""PyTorch port: the optimizer and the train step against the JAX package,
and the JAX package's train-step tests (``tests/test_train.py``) ported.

The step parity runs both packages from the same parameters (converted
from the flax tree), on the same batches (numpy, from a seed) and the
same noise (the JAX draws regenerated from each step's key, presence
uniforms binarized so that no sample can flip), for 3 steps; the JAX
step is traced once per case in a module-scoped fixture.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.convert import params_from_flax
from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
from attend_infer_repeat_torch.models.estimator import surrogate_loss
from attend_infer_repeat_torch.train import (
    Optimizer,
    create_train_state,
    make_eval_step,
    make_scan_train_step,
    make_train_step,
    param_count,
    prior_success_prob,
)
from attend_infer_repeat_torch.train.step import (
    kl_warmup,
    make_objective_loss_fn,
    step_generators,
)
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR
from attend_infer_repeat_tpu.train import state as jstate_mod
from attend_infer_repeat_tpu.train import step as jstep_mod
from torch_parity import (
    FAST,
    TINY,
    binarized_presence,
    forward_noise,
    images,
    to_numpy_tree,
)

torch.set_num_threads(1)


# -- the optimizer -----------------------------------------------------------

class TwoGroups(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cell = torch.nn.Linear(3, 4)
        self.decoder = torch.nn.Linear(2, 2, bias=False)
        self.baseline = torch.nn.Linear(4, 1)


def test_optimizer_matches_optax_over_5_updates():
    """Clipping active (the gradients' norm is ~30× the clip), the cosine
    schedule decaying within the 5 updates, the baseline at its own
    constant lr: parameters agree to f32 roundoff (rtol 1e-6)."""
    cfg = tcfg.TrainConfig(learning_rate=1e-2, lr_decay_steps=4,
                           lr_end_factor=0.1, baseline_learning_rate=3e-2,
                           grad_clip_norm=1.0, momentum=0.9)
    jc = jcfg.TrainConfig(**dataclasses.asdict(cfg))
    model = TwoGroups()
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(0)
    for p in model.parameters():
        p.data = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))

    def tree(arrays):                # flax layout: kernels (in, out)
        out = {}
        for n, a in zip(names, arrays):
            mod, leaf = n.split(".")
            out.setdefault(mod, {})[leaf] = jnp.asarray(a)
        return {"params": out}

    params = tree([p.detach().numpy() for p in model.parameters()])
    tx = jstate_mod.make_optimizer(jc, params)
    opt_state = tx.init(params)
    opt = Optimizer(cfg, model)
    state = opt.init()
    for _ in range(5):
        grads = [(rng.normal(size=p.shape) * 10).astype(np.float32)
                 for p in model.parameters()]
        assert float(optax.global_norm(tree(grads)["params"]["cell"])) > 10
        updates, opt_state = tx.update(tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.update({n: torch.from_numpy(g) for n, g in zip(names, grads)},
                   state)
        for n, p in model.named_parameters():
            mod, leaf = n.split(".")
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(params["params"][mod][leaf]),
                rtol=1e-6, atol=1e-7, err_msg=n)
    assert state["model"].count == state["baseline"].count == 5


@pytest.mark.parametrize("schedule", ["exp", "linear"])
def test_prior_success_prob_matches_jax(schedule):
    kw = dict(init_success_prob=0.9, final_success_prob=1e-4,
              anneal_start=10, anneal_steps=100, schedule=schedule)
    tc, jc = tcfg.PriorAnnealConfig(**kw), jcfg.PriorAnnealConfig(**kw)
    for step in (0, 10, 37, 60, 110, 1000):
        np.testing.assert_allclose(
            prior_success_prob(tc, step).item(),
            float(jstate_mod.prior_success_prob(jc, jnp.int32(step))),
            rtol=1e-6)


# -- the train step against the JAX step -------------------------------------

BATCH, STEPS = 8, 3
TRAIN = dict(batch_size=BATCH, learning_rate=1e-3, lr_decay_steps=10,
             baseline_learning_rate=1e-2, grad_clip_norm=100.0,
             kl_warmup_steps=2, l2_weight=1e-4)
PRIOR = dict(anneal_start=1, anneal_steps=4)
DATA = dict(canvas_size=(24, 24), digit_size=(8, 8))
# name: (model switches, free-running, tolerances).  Gradients are held
# by relative L2 per tensor, at step 0 and at later steps.
# Free-running: the port follows its own trajectory for STEPS steps.
# RMSProp's first updates normalise each gradient element, so roundoff in a
# near-zero element becomes an O(lr) parameter difference, and with the f32
# model the gradient gap grows from ~3e-6 at step 0 to ~5e-4 at step 3
# (measured); parameters stay within a tenth of one update.
# canonical_fast runs its networks in bf16 in both packages, rounded at
# different places: gradients 7.5e-3 apart at step 0 (measured).  After one
# update the trajectories part (sign flips of near-zero elements), so from
# step 1 on the port starts each step from the JAX step's parameters, and
# only the first update is compared (measured 0.074).  Those later steps
# differ more, up to 0.10 in the where head's gradients (measured): the
# where prior's scale of 0.03 multiplies rounding in the window by ~1/0.03²
# in the where KL.
CASES = {
    "f32_baseline": ({}, True, dict(grad=(1e-4, 2e-3), loss=2e-5,
                                    metric=1e-4, param=0.1)),
    "fast_switches_f32": (dict(FAST, dtype="float32",
                               canvas_carry_dtype=None), True,
                          dict(grad=(1e-4, 1e-4), loss=1e-5, metric=1e-5,
                               param=0.05)),
    "canonical_fast": (FAST, False, dict(grad=(2e-2, 0.15), loss=5e-3,
                                         metric=2e-2, update=0.15)),
}


def configs(switches, **train):
    kw = dict(model=dict(TINY, **switches), train=dict(TRAIN, **train),
              prior=PRIOR, data=DATA)

    def make(mod):
        return mod.Config(model=mod.ModelConfig(**kw["model"]),
                          train=mod.TrainConfig(**kw["train"]),
                          prior=mod.PriorAnnealConfig(**kw["prior"]),
                          data=mod.DataConfig(**kw["data"]))
    return make(jcfg), make(tcfg)


def batch(step):
    nums = np.random.default_rng(100 + step).integers(0, 3, BATCH)
    return images(BATCH, seed=100 + step), nums.astype(np.int32)


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request):
    """The JAX step's trajectory over STEPS steps: per step the loss,
    metrics, gradients (as the port's state_dict) and updated params."""
    switches, free, tol = CASES[request.param]
    jc, tc = configs(switches)
    jm = JaxAIR(jc.model, use_baseline=True)
    imgs0, _ = batch(0)
    state = jstate_mod.create_train_state(jc, jm, jnp.asarray(imgs0), seed=0)
    init = params_from_flax(to_numpy_tree(state.params))
    step = jstep_mod.make_train_step(jc, jm, donate=False)

    def loss(params, imgs, k_model, p_success, kl_beta):
        return jstep_mod.make_objective_loss_fn(
            jc, jm, imgs, k_model, p_success, kl_beta)(params)
    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))

    rows = []
    with binarized_presence():
        for s in range(STEPS):
            imgs, nums = batch(s)
            k_model = jax.random.split(jax.random.fold_in(state.base_key,
                                                          s))[1]
            p = jstate_mod.prior_success_prob(jc.prior, state.step)
            beta = jnp.clip(state.step.astype(jnp.float32) / 2, 0.0, 1.0)
            (lv, _), g = grad(state.params, jnp.asarray(imgs), k_model, p,
                              beta)
            state, metrics = step(state, (jnp.asarray(imgs),
                                          jnp.asarray(nums)))
            rows.append(dict(
                loss=float(lv), grads=params_from_flax(to_numpy_tree(g)),
                metrics={k: float(v) for k, v in metrics.items()},
                params=params_from_flax(to_numpy_tree(state.params)),
                noise=forward_noise(jc.model, k_model, BATCH,
                                    binarize=True)))
    return request.param, tc, init, rows, free, tol


def rel_l2(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def test_train_steps_match_jax(jax_run):
    """1 and 3 steps: loss, every metric, every gradient tensor and the
    updated parameters."""
    case, tc, init, rows, free, tol = jax_run
    state = create_train_state(tc, device="cpu")
    state.model.load_state_dict(init)
    step = make_train_step(tc, state.model)
    names, params = zip(*state.model.named_parameters())
    for s, ref in enumerate(rows):
        if s and not free:
            state.model.load_state_dict(rows[s - 1]["params"])
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        imgs, nums = (torch.from_numpy(a) for a in batch(s))
        loss, _ = make_objective_loss_fn(
            tc, state.model, imgs, None,
            prior_success_prob(tc.prior, s), kl_warmup(tc, s),
            ref["noise"])()
        np.testing.assert_allclose(loss.item(), ref["loss"],
                                   rtol=tol["loss"])
        grads = torch.autograd.grad(loss, params)
        for n, g in zip(names, grads):
            err = rel_l2(g, ref["grads"][n])
            assert err <= tol["grad"][s > 0], (case, s, n, err)
        state, metrics = step(state, (imgs, nums), noise=ref["noise"])
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(metrics[k].item(), v,
                                       rtol=tol["metric"], atol=1e-6,
                                       err_msg=f"{case} step {s} {k}")
        np.testing.assert_allclose(metrics["loss"].item(), ref["loss"],
                                   rtol=tol["loss"])
        after = state.model.state_dict()
        start = init if s == 0 else rows[s - 1]["params"]
        for n, v in ref["params"].items():
            if free:
                # within a fraction of one update (~lr) of the JAX step's
                lr = TRAIN["baseline_learning_rate"] if n.startswith(
                    "baseline.") else TRAIN["learning_rate"]
                err = (after[n] - v).abs().max().item()
                assert err <= tol["param"] * lr, (case, s, n, err)
            elif s == 0:
                err = rel_l2(after[n] - before[n], v - start[n])
                assert err <= tol["update"], (case, n, err)
    assert state.step == STEPS


# -- the JAX package's train-step tests, ported ------------------------------

def tiny_config(**train_kw) -> tcfg.Config:
    return tcfg.Config(
        model=tcfg.ModelConfig(
            img_size=(14, 14), glimpse_size=(6, 6), n_what=4, max_steps=2,
            rnn_hidden=16, encoder_hidden=(16,),
            glimpse_encoder_hidden=(16,), decoder_hidden=(16,),
            transform_hidden=(16,), steps_hidden=(8,),
            baseline_hidden=(16,)),
        data=tcfg.DataConfig(canvas_size=(14, 14), digit_size=(8, 8),
                             min_digits=0, max_digits=2),
        train=tcfg.TrainConfig(batch_size=8, learning_rate=1e-4,
                               **train_kw),
        prior=tcfg.PriorAnnealConfig(anneal_start=2, anneal_steps=10))


@pytest.fixture(scope="module")
def bank():
    imgs, _ = load_digit_bank("auto", digit_size=(8, 8))
    return imgs


@pytest.fixture
def setup():
    cfg = tiny_config()
    state = create_train_state(cfg, device="cpu")
    return cfg, state


def params_of(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_train_step_runs_updates_and_is_deterministic(setup, bank):
    cfg, state = setup
    other = copy.deepcopy(state)
    before = params_of(state)
    s1, m1 = make_train_step(cfg, state.model, digit_bank=bank)(state)
    s2, m2 = make_train_step(cfg, other.model, digit_bank=bank)(other)
    assert s1.step == s2.step == 1
    assert np.isfinite(m1["elbo"].item()) and np.isfinite(
        m1["grad_norm"].item())
    assert m1["elbo"].item() == m2["elbo"].item()
    for k, v in params_of(s1).items():
        assert torch.equal(v, params_of(s2)[k])
    assert max((v - before[k]).abs().max().item()
               for k, v in params_of(s1).items()) > 0


def test_scan_train_step_matches_sequential(setup, bank):
    cfg, state = setup
    seq = copy.deepcopy(state)
    step = make_train_step(cfg, seq.model, digit_bank=bank)
    elbos = []
    for _ in range(3):
        seq, m = step(seq)
        elbos.append(m["elbo"].item())
    scan, ms = make_scan_train_step(cfg, state.model, bank, 3)(state)
    assert scan.step == seq.step == 3
    assert ms["elbo"].shape == (3,) and ms["elbo"].tolist() == elbos
    for k, v in params_of(seq).items():
        assert torch.equal(v, params_of(scan)[k])


def test_device_data_step_and_scan(setup, bank):
    cfg, state = setup
    synth = make_synth_fn(cfg.data, bank, device="cpu")
    dd = synth(64, torch.Generator().manual_seed(7))
    seq = copy.deepcopy(state)
    step = make_train_step(cfg, seq.model, device_data=dd)
    for _ in range(3):
        seq, m = step(seq)
        assert np.isfinite(m["elbo"].item())
    scan, _ = make_scan_train_step(cfg, state.model, None, 3,
                                   device_data=dd)(state)
    assert scan.step == seq.step == 3
    for k, v in params_of(seq).items():
        assert torch.equal(v, params_of(scan)[k])
    with pytest.raises(ValueError):
        make_train_step(cfg, state.model, digit_bank=bank, device_data=dd)
    with pytest.raises(ValueError, match="on-device data"):
        make_scan_train_step(cfg, state.model, None, 3)


def test_step_generators_depend_on_seed_and_step():
    def draw(seed, step):
        return [torch.rand(3, generator=g).tolist()
                for g in step_generators(seed, step, "cpu")]
    assert draw(0, 1) == draw(0, 1)
    assert draw(0, 1) != draw(0, 2) and draw(0, 1) != draw(1, 1)
    assert draw(0, 1)[0] != draw(0, 1)[1]


def test_baseline_gradient_isolation(setup, bank):
    """The REINFORCE and ELBO terms do not reach the baseline, and the
    baseline MSE does not reach the model."""
    cfg, state = setup
    model = state.model
    imgs, _ = make_synth_fn(cfg.data, bank, device="cpu")(
        8, torch.Generator().manual_seed(5))
    imgs = imgs.clone()                      # an ordinary tensor, not inference
    noise = model.sample_noise(8, torch.Generator().manual_seed(6))
    names, params = zip(*model.named_parameters())

    def grads(loss_fn):
        out = model(imgs, 0.5, noise=noise)
        gs = torch.autograd.grad(loss_fn(out), params, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, gs)}

    def no_baseline_mse(out):
        from attend_infer_repeat_torch.models.estimator import (
            presence_log_prob)
        adv = out.elbo.detach()[:, None] - out.baseline.detach()
        return torch.mean(-out.elbo - torch.sum(
            adv * presence_log_prob(out), dim=-1))

    g_full = grads(lambda o: surrogate_loss(o)[0])
    g_nomse = grads(no_baseline_mse)
    for n in names:
        if n.startswith("baseline."):
            assert torch.equal(g_nomse[n], torch.zeros_like(g_nomse[n]))
        else:
            torch.testing.assert_close(g_full[n], g_nomse[n], rtol=1e-5,
                                       atol=1e-6)
    assert max(g_full[n].abs().max().item() for n in names
               if n.startswith("baseline.")) > 0


def test_eval_step_changes_no_param(setup, bank):
    cfg, state = setup
    imgs, nums = make_synth_fn(cfg.data, bank, device="cpu")(
        8, torch.Generator().manual_seed(9))
    before = params_of(state)
    metrics, outputs = make_eval_step(cfg, state.model)(
        state, imgs, nums, torch.Generator().manual_seed(10))
    assert 0.0 <= metrics["count_accuracy"].item() <= 1.0
    assert outputs.canvas.shape == imgs.shape
    for k, v in params_of(state).items():
        assert torch.equal(v, before[k])


def test_no_baseline_ablation(bank):
    cfg = tiny_config(use_baseline=False)
    state = create_train_state(cfg, device="cpu")
    assert not any(n.startswith("baseline.")
                   for n, _ in state.model.named_parameters())
    assert "baseline" not in param_count(state.model)
    state, metrics = make_train_step(cfg, state.model, digit_bank=bank)(state)
    assert np.isfinite(metrics["elbo"].item())
    assert metrics["baseline_mse"].item() == 0.0


def test_iwae_objective_step_and_scan(bank):
    cfg = tiny_config(objective="iwae", iwae_particles=3,
                      use_baseline=False, scan_steps=2)
    state = create_train_state(cfg, device="cpu")
    before = params_of(state)
    other = copy.deepcopy(state)
    state, metrics = make_train_step(cfg, state.model, digit_bank=bank)(state)
    assert np.isfinite(metrics["iwae_bound"].item())
    assert metrics["iwae_bound"].item() >= metrics["log_w_mean"].item() - 1e-5
    assert 1.0 <= metrics["ess"].item() <= 3.0 + 1e-6
    assert any(not torch.equal(v, before[k])
               for k, v in params_of(state).items())
    s2, chunk = make_scan_train_step(cfg, other.model, bank, 2)(other)
    assert s2.step == 2 and bool(torch.isfinite(chunk["iwae_bound"]).all())


def test_canonical_fast_preset_runs_as_written_and_warns_remat(bank):
    """The preset sets remat ``save_st``, which the cell honours: building
    the step raises no warning, and the step runs with remat.  (Widths cut
    to the tiny test model.)"""
    import warnings

    fast = tcfg.get_config("canonical_fast")
    cfg = dataclasses.replace(
        fast, model=dataclasses.replace(fast.model, **TINY),
        data=dataclasses.replace(fast.data, canvas_size=(24, 24),
                                 digit_size=(8, 8)),
        train=dataclasses.replace(fast.train, batch_size=4))
    assert cfg.model.remat and cfg.model.remat_policy == "save_st"
    state = create_train_state(cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = make_train_step(cfg, state.model, digit_bank=bank)
        recomputed = []
        hook = state.model.cell.encoder.register_forward_hook(
            lambda *a: recomputed.append(torch.is_grad_enabled()))
        try:
            state, metrics = step(state)
        finally:
            hook.remove()
    # the encoder ran 3 times forward and 3 more in the backward (remat)
    assert len(recomputed) == 2 * cfg.model.max_steps
    assert all(np.isfinite(v.item()) for v in metrics.values())
    with pytest.raises(ValueError, match="not the model"):
        step(create_train_state(cfg, device="cpu"))


# -- remat: the JAX package's nn.remat, as torch.utils.checkpoint -----------

@pytest.mark.parametrize("switches", [{}, FAST], ids=["f32", "fast"])
def test_remat_gives_the_same_loss_and_gradients(switches):
    """``save_st`` and ``full`` recompute the cell in the backward; on the
    CPU the loss and every gradient are bit-equal to no remat.  ``full``
    re-runs the spatial transformer's forward, ``save_st`` does not."""
    from attend_infer_repeat_torch.models.air import AIRModel
    from attend_infer_repeat_torch.ops import st_kernel

    x = torch.from_numpy(images(6))
    results = {}
    for policy in (None, "save_st", "full"):
        mcfg = tcfg.ModelConfig(**TINY, **switches, remat=policy is not None,
                                remat_policy=policy or "full")
        model = AIRModel(mcfg, device="cpu", seed=0)
        noise = model.sample_noise(6, torch.Generator().manual_seed(1))
        loss, _ = surrogate_loss(model(x, 0.5, noise=noise))
        calls = []
        orig = st_kernel.st_gather_plain   # every ST forward on the CPU

        def counting(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)
        st_kernel.st_gather_plain = counting
        try:
            grads = torch.autograd.grad(loss, list(model.parameters()))
        finally:
            st_kernel.st_gather_plain = orig
        results[policy] = (loss, grads, len(calls))
    ref_loss, ref_grads, _ = results[None]
    for policy, (loss, grads, st_calls) in results.items():
        assert torch.equal(loss, ref_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads)), \
            policy
    # in the backward, "full" runs each step's gather and paste again
    assert results["save_st"][2] == results[None][2] == 0
    assert results["full"][2] == 2 * TINY["max_steps"]


def test_remat_rejects_an_unknown_policy():
    from attend_infer_repeat_torch.models.air import AIRModel

    model = AIRModel(tcfg.ModelConfig(**TINY, remat=True,
                                      remat_policy="nope"), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        model(torch.from_numpy(images(2)), 0.5)


# -- the K-step chunk's replay logic, without the capture ---------------------

def test_step_graph_logic_equals_eager_steps(setup, bank):
    """``StepGraph`` with its capture stubbed out (each "replay" runs the
    body it would capture, eagerly): the warm-up leaves the state as it
    was, the schedule table, the row index, the per-step seeds and the
    metric buffer give two chunks equal to six eager steps, bit for bit.
    (The capture itself needs the card: ``test_torch_graph_cuda.py``.)"""
    from attend_infer_repeat_torch.train.step import StepGraph, _TrainStep

    class Uncaptured(StepGraph):
        def _capture(self, state, capture):
            self._state = state
            return (0, 0)

        def _launch(self):
            self._body(self._state)

    base, _ = setup
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, kl_warmup_steps=4, lr_decay_steps=5))
    state = create_train_state(cfg, device="cpu")
    eager = copy.deepcopy(state)
    ts = _TrainStep(cfg, state.model, digit_bank=bank)
    before = params_of(state)
    graph = Uncaptured(ts, state, 3)
    assert state.step == 0 and all(
        torch.equal(v, before[k]) for k, v in params_of(state).items())
    chunks = [graph.replay(state)[1] for _ in range(2)]
    step = make_train_step(cfg, eager.model, digit_bank=bank)
    rows = [step(eager)[1] for _ in range(6)]
    assert state.step == eager.step == 6
    assert state.opt_state["model"].count == eager.opt_state["model"].count
    for k, v in params_of(eager).items():
        assert torch.equal(v, params_of(state)[k]), k
    for c, chunk in enumerate(chunks):
        for k, v in chunk.items():
            want = torch.stack([r[k] for r in rows[3 * c:3 * c + 3]])
            assert torch.equal(v, want), (c, k)
    assert len(set(chunks[1]["prior_success_prob"].tolist())) == 3
