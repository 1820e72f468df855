"""PyTorch port: the gradient estimators against the JAX package, and the
exact-gradient toy tests of ``tests/test_estimator.py`` ported.

Every estimator function gets the same fabricated model outputs (numpy,
from a seed) in both packages; values and gradients are compared to f32
roundoff (rtol 1e-5).  The toy tests check the estimators against exact
enumerated gradients within Monte-Carlo error, as the JAX package's do.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.models import estimator as test
from attend_infer_repeat_torch.models.air import AIRModel as TorchAIR
from attend_infer_repeat_torch.models.air import AIROutputs as TOut
from attend_infer_repeat_torch.models.cell import AIRStepOutput as TStep
from attend_infer_repeat_torch.ops.distributions import (
    bernoulli_log_prob as t_bernoulli_log_prob,
)
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.models import estimator as jest
from attend_infer_repeat_tpu.models.air import AIROutputs as JOut
from attend_infer_repeat_tpu.models.cell import AIRStepOutput as JStep

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B, T, NW = 6, 3, 4

# what flows into a gradient: the leaves both packages differentiate by
GRAD_LEAVES = ("elbo", "kl_what", "baseline", "pres_prob", "log_likelihood",
               "where_loc", "where_scale", "what_loc", "what_scale",
               "z_what", "z_where")


def fabricated(seed=0, isotropic=False, baseline=True):
    """Consistent fake model outputs as numpy arrays."""
    rng = np.random.default_rng(seed)
    d = 3 if isotropic else 4
    pres = np.ones((B, T), np.float32)
    u = rng.random((B, T))
    p_raw = rng.uniform(0.05, 0.95, (B, T)).astype(np.float32)
    for i in range(T):                       # monotone chain
        prev = pres[:, i - 1] if i else 1.0
        pres[:, i] = prev * (u[:, i] < p_raw[:, i])
    pres_prev = np.concatenate([np.ones((B, 1)), pres[:, :-1]], 1)
    pres_prob = (p_raw * pres_prev).astype(np.float32)
    cp = np.cumprod(pres_prob, 1)
    pmf = np.concatenate([np.ones((B, 1)), cp], 1) * np.concatenate(
        [1 - pres_prob, np.zeros((B, 1))], 1)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a = dict(
        elbo=f(B) * 50 - 200, log_likelihood=f(B) * 50 - 150,
        kl_what=np.abs(f(B)) * 10, kl_where=np.abs(f(B)) * 5,
        kl_steps=np.abs(f(B)), canvas=f(B, 2, 2), glimpses=f(B, T, 2, 2),
        num_steps_pmf=pmf.astype(np.float32),
        expected_steps=(pmf * np.arange(T + 1)).sum(1).astype(np.float32),
        predicted_steps=pres.sum(1), mode_steps=pmf.argmax(1).astype(
            np.float32),
        baseline=(f(B, T) * 50 - 200) if baseline else None,
        where_loc=f(B, T, d) * 0.1, where_scale=np.abs(f(B, T, d)) + 0.1,
        what_loc=f(B, T, NW), what_scale=np.abs(f(B, T, NW)) + 0.5,
        z_what=f(B, T, NW), pres_prob=pres_prob, pres=pres,
        pres_prev=pres_prev.astype(np.float32), glimpse=f(B, T, 2, 2))
    zw = f(B, T, 4) * 0.2
    if isotropic:
        zw[..., 1] = zw[..., 0]
    a["z_where"] = zw
    return a


STEP_FIELDS = ("where_loc", "where_scale", "z_where", "what_loc",
               "what_scale", "z_what", "pres_prob", "pres", "pres_prev",
               "glimpse")


def build(arrays, out_cls, step_cls, conv):
    steps = step_cls(**{k: conv(arrays[k]) for k in STEP_FIELDS})
    rest = {k: conv(v) for k, v in arrays.items()
            if k not in STEP_FIELDS and k != "glimpse"}
    return out_cls(steps=steps, **rest)


def to_jax(a):
    return None if a is None else jnp.asarray(a)


def run_both(fn_t, fn_j, arrays):
    """Value and gradient w.r.t. GRAD_LEAVES of ``fn(outputs)`` in both.

    ``fn`` returns (scalar, aux); the gradient is of the scalar."""
    leaves = [k for k in GRAD_LEAVES if arrays.get(k) is not None]
    t_leaves = {k: torch.tensor(arrays[k], requires_grad=True)
                for k in leaves}
    tarr = {k: (t_leaves[k] if k in t_leaves else
                (None if v is None else torch.from_numpy(np.asarray(v))))
            for k, v in arrays.items()}
    t_val, t_aux = fn_t(build(tarr, TOut, TStep, lambda x: x))

    def j_fn(leaf_vals):
        jarr = {k: (leaf_vals[k] if k in leaf_vals else to_jax(v))
                for k, v in arrays.items()}
        return fn_j(build(jarr, JOut, JStep, lambda x: x))

    j_leaves = {k: jnp.asarray(arrays[k]) for k in leaves}
    (j_val, j_aux) = j_fn(j_leaves)
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    j_grad = jax.grad(lambda lv: j_fn(lv)[0])(j_leaves)
    t_grad = torch.autograd.grad(t_val, [t_leaves[k] for k in leaves],
                                 allow_unused=True)
    for k, g in zip(leaves, t_grad):
        g = torch.zeros_like(t_leaves[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grad[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    return t_aux, j_aux


def same_metrics(t_m, j_m):
    assert set(t_m) == set(j_m)
    for k in t_m:
        np.testing.assert_allclose(t_m[k].item(), float(j_m[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kl_beta,advantage_norm,baseline,l2", [
    (1.0, False, True, 0.0), (0.3, False, True, 0.0),
    (0.3, True, True, 0.0), (1.0, True, False, 0.0),
    (0.7, False, False, 1e-3)])
def test_surrogate_loss_matches_jax(kl_beta, advantage_norm, baseline, l2):
    arrays = fabricated(1, baseline=baseline)
    kw = dict(l2_params_norm=2.5, l2_weight=l2, kl_beta=kl_beta,
              advantage_norm=advantage_norm)
    t_m, j_m = run_both(lambda o: test.surrogate_loss(o, **kw),
                        lambda o: jest.surrogate_loss(o, **kw), arrays)
    same_metrics(t_m, j_m)
    assert ("advantage_std" in t_m) == advantage_norm


def test_presence_log_prob_and_count_accuracy_match_jax():
    arrays = fabricated(2)
    t_out = build({k: None if v is None else torch.from_numpy(np.asarray(v))
                   for k, v in arrays.items()}, TOut, TStep, lambda x: x)
    j_out = build({k: to_jax(v) for k, v in arrays.items()}, JOut, JStep,
                  lambda x: x)
    np.testing.assert_allclose(test.presence_log_prob(t_out).numpy(),
                               np.asarray(jest.presence_log_prob(j_out)),
                               rtol=RTOL, atol=ATOL)
    nums = np.array([0, 1, 2, 3, 1, 2], np.int32)
    for mode in (False, True):
        assert test.count_accuracy(t_out, torch.from_numpy(nums),
                                   use_mode=mode).item() == float(
            jest.count_accuracy(j_out, jnp.asarray(nums), use_mode=mode))


@pytest.mark.parametrize("isotropic,what_weight", [(False, 1.0),
                                                   (True, 0.4)])
def test_log_importance_weights_match_jax(isotropic, what_weight):
    arrays = fabricated(3, isotropic=isotropic)
    kw = dict(img_size=(8, 8), glimpse_size=(4, 4), n_what=NW,
              max_steps=T, isotropic_scale=isotropic)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    run_both(
        lambda o: (test.log_importance_weights(o, tc, 0.3, what_weight)
                   .sum(), None),
        lambda o: (jest.log_importance_weights(o, jc, 0.3, what_weight)
                   .sum(), None), arrays)


def test_vimco_and_iwae_bound_match_jax():
    rng = np.random.default_rng(4)
    lw = (rng.normal(size=(5, 7)) * 3).astype(np.float32)
    lq = (rng.normal(size=(5, 7))).astype(np.float32)
    tw, tq = (torch.tensor(a, requires_grad=True) for a in (lw, lq))
    t_loss, t_m = test.vimco_surrogate_loss(tw, tq)
    (j_loss, j_m), j_grad = jax.value_and_grad(
        jest.vimco_surrogate_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lw), jnp.asarray(lq))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL)
    same_metrics(t_m, j_m)
    for a, b in zip(torch.autograd.grad(t_loss, (tw, tq)), j_grad):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for dim in (0, 1):
        np.testing.assert_allclose(
            test.iwae_bound(torch.from_numpy(lw), dim).numpy(),
            np.asarray(jest.iwae_bound(jnp.asarray(lw), dim)), rtol=RTOL)


# -- the exact-gradient toy tests (tests/test_estimator.py), ported --------

def _toy_outputs(theta, u, a=2.0, c=-1.0, baseline_val=None):
    """AIROutputs of a 2-step monotone chain driven by theta (2,), one
    example per row of the uniforms ``u (B, 2)``: p_t = sigmoid(theta_t);
    elbo = a·(pres_1 + pres_2) + c + 0.1·theta_0."""
    p_raw = torch.sigmoid(theta)
    n = u.shape[0]
    pres1 = (u[:, 0] < p_raw[0]).float()
    p2_eff = p_raw[1] * pres1
    pres2 = (u[:, 1] < p2_eff).float()
    pres = torch.stack([pres1, pres2], -1)
    pres_prob = torch.stack([p_raw[0].expand(n), p2_eff], -1)
    pres_prev = torch.cat([torch.ones((n, 1)), pres[:, :1]], -1)
    elbo = a * pres.sum(-1) + c + 0.1 * theta[0]
    z = torch.zeros((n, 2, 1))
    steps = TStep(where_loc=z, where_scale=z + 1, z_where=z, what_loc=z,
                  what_scale=z + 1, z_what=z, pres_prob=pres_prob, pres=pres,
                  pres_prev=pres_prev, glimpse=torch.zeros((n, 2, 1, 1)))
    zero = torch.zeros(n)
    return TOut(elbo=elbo, log_likelihood=elbo, kl_what=zero, kl_where=zero,
                kl_steps=zero, canvas=torch.zeros((n, 1, 1)),
                glimpses=torch.zeros((n, 2, 1, 1)), steps=steps,
                num_steps_pmf=torch.zeros((n, 3)), expected_steps=zero,
                predicted_steps=pres.sum(-1), mode_steps=pres.sum(-1),
                baseline=None if baseline_val is None
                else torch.full((n, 2), baseline_val))


def _exact_objective(theta, a=2.0, c=-1.0):
    """Enumerated E[elbo] over the 3 outcomes of the monotone chain."""
    p1, p2 = torch.sigmoid(theta[0]), torch.sigmoid(theta[1])
    e0 = c + 0.1 * theta[0]
    return ((1 - p1) * e0 + p1 * (1 - p2) * (a + e0)
            + p1 * p2 * (2 * a + e0))


def _grad(fn, theta):
    th = theta.clone().requires_grad_()
    (g,) = torch.autograd.grad(fn(th), th)
    return g.numpy()


def _uniforms(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((n, 2))
                            .astype(np.float32))


THETA = torch.tensor([0.3, -0.4])


class TestEnumeratedGradient:
    def test_reinforce_matches_exact_gradient(self):
        u = _uniforms(60_000, 0)
        got = _grad(lambda th: -test.surrogate_loss(_toy_outputs(th, u))[0],
                    THETA)
        np.testing.assert_allclose(got, _grad(_exact_objective, THETA),
                                   atol=0.03, rtol=0.05)

    def test_advantage_norm_preserves_direction(self):
        u = _uniforms(60_000, 1)
        _, metrics = test.surrogate_loss(_toy_outputs(THETA, u),
                                         advantage_norm=True)
        got = _grad(lambda th: -test.surrogate_loss(
            _toy_outputs(th, u), advantage_norm=True)[0], THETA)
        scale = max(1.0, metrics["advantage_std"].item())
        assert scale > 1.0
        np.testing.assert_allclose(got[1] * scale,
                                   _grad(_exact_objective, THETA)[1],
                                   atol=0.03, rtol=0.05)

    def test_baseline_reduces_variance_not_bias(self):
        want = _grad(_exact_objective, THETA)
        b = _exact_objective(THETA).item()

        def per_chunk(baseline_val, seed):
            u = _uniforms(2000, seed)
            return _grad(lambda th: -test.surrogate_loss(
                _toy_outputs(th, u, baseline_val=baseline_val))[0], THETA)

        g_nob = np.stack([per_chunk(None, s) for s in range(20)])
        g_b = np.stack([per_chunk(b, s) for s in range(20)])
        np.testing.assert_allclose(g_b.mean(0), want, atol=0.05, rtol=0.1)
        np.testing.assert_allclose(g_nob.mean(0), want, atol=0.05, rtol=0.1)
        assert g_b.var(0).sum() < g_nob.var(0).sum()

    def test_masked_logq_zero_after_stop(self):
        u = _uniforms(4, 1)
        lq = test.presence_log_prob(_toy_outputs(torch.tensor([10., -10.]),
                                                 u))
        assert bool(torch.isfinite(lq).all())
        lq2 = test.presence_log_prob(_toy_outputs(torch.tensor([-10., 0.]),
                                                  u))
        np.testing.assert_allclose(lq2[:, 1].numpy(), 0.0, atol=1e-6)


class TestGradientSplit:
    """The baseline parameters get only the MSE gradient; model parameters
    get none of it (the port's model, the ``single_digit`` preset)."""

    def setup_method(self):
        self.model = TorchAIR(tcfg.get_config("single_digit").model,
                              device="cpu", seed=1)
        self.x = torch.rand((2, 50, 50),
                            generator=torch.Generator().manual_seed(0))
        self.noise = self.model.sample_noise(
            2, torch.Generator().manual_seed(3))

    def _grads(self, loss_fn):
        out = self.model(self.x, 0.5, noise=self.noise)
        names, params = zip(*self.model.named_parameters())
        gs = torch.autograd.grad(loss_fn(out), params, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, gs)}

    @staticmethod
    def _mse(out):
        sig = out.elbo.detach()[:, None]
        return torch.mean(torch.sum((out.baseline - sig) ** 2, dim=-1))

    def test_baseline_gets_only_mse_gradient(self):
        g_full = self._grads(lambda o: test.surrogate_loss(o)[0])
        g_mse = self._grads(self._mse)
        for n in g_full:
            if n.startswith("baseline."):
                torch.testing.assert_close(g_full[n], g_mse[n], rtol=1e-5,
                                           atol=1e-7)

    def test_model_params_free_of_mse_gradient(self):
        g_full = self._grads(lambda o: test.surrogate_loss(o)[0])
        g_nomse = self._grads(
            lambda o: test.surrogate_loss(o)[0] - self._mse(o))
        model_names = [n for n in g_full if not n.startswith("baseline.")]
        assert model_names
        for n in model_names:
            torch.testing.assert_close(g_full[n], g_nomse[n], rtol=1e-5,
                                       atol=1e-7)


class TestVimco:
    A, C = 2.0, -1.0

    def _sample_particle(self, u, th):
        p = torch.sigmoid(th)
        pres1 = (u[:, 0] < p[0]).float()
        p2_eff = p[1] * pres1
        pres2 = (u[:, 1] < p2_eff).float()
        lq = t_bernoulli_log_prob(pres1, p[0]) \
            + pres1 * t_bernoulli_log_prob(pres2, p[1])
        return self.A * (pres1 + pres2) + self.C + 0.1 * th[0] - lq, lq

    def _exact_bound(self, th, k=2):
        p = torch.sigmoid(th)
        q = torch.stack([1 - p[0], p[0] * (1 - p[1]), p[0] * p[1]])
        lw = self.A * torch.arange(3.) + self.C + 0.1 * th[0] - torch.log(q)
        obj = 0.0
        for combo in itertools.product(range(3), repeat=k):
            prob = torch.prod(torch.stack([q[i] for i in combo]))
            vals = torch.stack([lw[i] for i in combo])
            obj = obj + prob * (torch.logsumexp(vals, 0) - np.log(k))
        return obj

    def test_vimco_matches_exact_gradient(self):
        u0, u1 = _uniforms(100_000, 0), _uniforms(100_000, 1)

        def neg_loss(th):
            lw0, lq0 = self._sample_particle(u0, th)
            lw1, lq1 = self._sample_particle(u1, th)
            return -test.vimco_surrogate_loss(torch.stack([lw0, lw1]),
                                              torch.stack([lq0, lq1]))[0]

        np.testing.assert_allclose(_grad(neg_loss, THETA),
                                   _grad(self._exact_bound, THETA),
                                   atol=0.05, rtol=0.05)

    def test_vimco_rejects_single_particle(self):
        with pytest.raises(ValueError, match="k >= 2"):
            test.vimco_surrogate_loss(torch.zeros((1, 4)), torch.zeros((1, 4)))

    def test_vimco_bound_value_matches_iwae_bound(self):
        lw = torch.from_numpy(np.random.default_rng(2).normal(
            size=(5, 32)).astype(np.float32))
        _, metrics = test.vimco_surrogate_loss(lw, torch.zeros((5, 32)))
        np.testing.assert_allclose(metrics["iwae_bound"].item(),
                                   test.iwae_bound(lw, 0).mean().item(),
                                   rtol=1e-6)

    def test_vimco_what_weight_warmup_path(self):
        cfg = tcfg.ModelConfig(
            img_size=(8, 8), glimpse_size=(4, 4), n_what=2, max_steps=2,
            rnn_hidden=8, encoder_hidden=(8,), glimpse_encoder_hidden=(8,),
            decoder_hidden=(8,), transform_hidden=(8,), steps_hidden=(4,),
            baseline_hidden=(8,))
        model = TorchAIR(cfg, device="cpu", seed=1)
        x = torch.rand((4, 8, 8), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            out = model(x, 0.5, generator=torch.Generator().manual_seed(3))
        lw1 = test.log_importance_weights(out, cfg, 0.5, what_weight=1.0)
        torch.testing.assert_close(
            lw1, test.log_importance_weights(out, cfg, 0.5), rtol=1e-6,
            atol=0)
        lw0 = test.log_importance_weights(out, cfg, 0.5, what_weight=0.0)
        assert bool(torch.isfinite(lw0).all())
        fired = out.steps.pres.sum(-1) > 0
        if fired.any():
            assert bool((lw0[fired] != lw1[fired]).any())
