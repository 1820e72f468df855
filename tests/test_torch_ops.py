"""PyTorch port: math and distribution helpers against the JAX package,
in value and in gradient."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch.ops import distributions as tdist
from attend_infer_repeat_torch.ops import math as tmath
from attend_infer_repeat_tpu.ops import distributions as jdist
from attend_infer_repeat_tpu.ops import math as jmath

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=atol)


def both(x):
    """The same float32 values as a torch leaf (with grad) and a jax array."""
    x = np.asarray(x, np.float32)
    return torch.tensor(x, requires_grad=True), jnp.asarray(x)


def grad_pair(f_torch, f_jax, *xs):
    """Value and gradient of ``sum(f(x) * w)`` in both frameworks."""
    pairs = [both(x) for x in xs]
    out_t = f_torch(*[p[0] for p in pairs])
    w = np.random.default_rng(0).normal(size=tuple(out_t.shape)).astype(
        np.float32)
    (out_t * torch.from_numpy(w)).sum().backward()
    g_j = jax.grad(lambda *a: jnp.sum(f_jax(*a) * w),
                   argnums=tuple(range(len(xs))))(*[p[1] for p in pairs])
    close(out_t, f_jax(*[p[1] for p in pairs]))
    for (t, _), gj in zip(pairs, g_j):
        close(t.grad, gj, rtol=1e-4, atol=1e-5)


def test_clip_preserve_value_and_identity_grad():
    x = np.array([-2.0, -0.5, 0.0, 0.3, 1.5, 9.0], np.float32)
    grad_pair(lambda a: tmath.clip_preserve(a, -1.0, 1.0),
              lambda a: jmath.clip_preserve(a, -1.0, 1.0), x)
    t = torch.tensor(x, requires_grad=True)
    tmath.clip_preserve(t, -1.0, 1.0).sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))


@pytest.mark.parametrize("step", [0, 500, 1_000, 20_000, 101_000, 500_000])
def test_anneals(step):
    args = (1.0 - 1e-7, 1e-5, 1_000, 101_000)
    close(tmath.linear_anneal(step, *args), jmath.linear_anneal(step, *args))
    close(tmath.exp_anneal(step, *args), jmath.exp_anneal(step, *args),
          rtol=2e-5, atol=0)


def test_masked_mean():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    m = (rng.random((4, 5)) > 0.5).astype(np.float32)
    m[0] = 0.0
    for axis in (None, 0, 1):
        close(tmath.masked_mean(torch.tensor(x), torch.tensor(m), dim=axis),
              jmath.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=axis))


@pytest.mark.parametrize("q", [1e-9, 1e-5, 0.3, 0.5, 0.9, 1.0 - 1e-7, 1.0])
def test_geometric_prior_value_and_grad(q):
    close(tdist.geometric_prior(q, 3), jdist.geometric_prior(q, 3))
    if 0.0 < q < 1.0 - 1e-6:
        grad_pair(lambda a: tdist.geometric_prior(a, 3),
                  lambda a: jdist.geometric_prior(a, 3), np.float32(q))


def test_presence_pmf_value_grad_and_enumeration():
    rng = np.random.default_rng(2)
    p = rng.uniform(size=(6, 4)).astype(np.float32)
    p[0, 1] = 0.0
    grad_pair(tdist.presence_pmf, jdist.presence_pmf, p)
    # brute force over the 2^T outcomes of the monotone chain
    q = p[1]
    enum = np.zeros(5)
    for bits in itertools.product([0, 1], repeat=4):
        prob, prev = 1.0, 1.0
        for t, b in enumerate(bits):
            eff = q[t] * prev
            prob *= eff if b else 1 - eff
            prev *= b
        n = next((i for i, b in enumerate(bits) if not b), 4)
        enum[n] += prob
    close(tdist.presence_pmf(torch.tensor(q)), enum)


def test_num_steps_distribution():
    rng = np.random.default_rng(3)
    p = rng.uniform(size=(8, 3)).astype(np.float32)
    p[:2, 1] = 0.0
    td = tdist.NumStepsDistribution(torch.tensor(p))
    jd = jdist.NumStepsDistribution(jnp.asarray(p))
    assert td.n_steps == jd.n_steps == 3
    close(td.pmf(), jd.pmf())
    close(td.log_pmf(), jd.log_pmf(), rtol=1e-5, atol=1e-5)
    close(td.expectation(), jd.expectation())
    assert np.array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    key = jax.random.key(4)
    u = torch.from_numpy(np.array(jax.random.uniform(key, p.shape)))
    assert np.array_equal(td.sample(u=u).numpy(), np.asarray(jd.sample(key)))
    s = td.sample(torch.Generator().manual_seed(0))
    assert s.shape == (8,) and bool(((s >= 0) & (s <= 3)).all())


def test_tabular_kl_value_and_grad_with_zeros():
    q = np.array([[0.0, 0.2, 0.8], [0.5, 0.5, 0.0]], np.float32)
    p = np.array([[0.3, 0.3, 0.4], [1e-20, 0.9, 0.1]], np.float32)
    grad_pair(tdist.tabular_kl, jdist.tabular_kl, q, p)


def test_normal_kl_log_prob_and_bernoulli():
    rng = np.random.default_rng(5)
    lq, lp = rng.normal(size=(2, 7)).astype(np.float32)
    sq, sp = rng.uniform(0.05, 2.0, size=(2, 7)).astype(np.float32)
    grad_pair(tdist.normal_kl, jdist.normal_kl, lq, sq, lp, sp)
    grad_pair(tdist.normal_log_prob, jdist.normal_log_prob, lq, lp, sp)
    close(tdist.normal_log_prob(torch.tensor(lq), torch.tensor(lp), 0.3),
          jdist.normal_log_prob(jnp.asarray(lq), jnp.asarray(lp), 0.3))
    x = (rng.random(7) > 0.5).astype(np.float32)
    prob = np.array([0.0, 1.0, 0.3, 0.7, 1e-9, 0.5, 0.999], np.float32)
    grad_pair(lambda a: tdist.bernoulli_log_prob(torch.tensor(x), a),
              lambda a: jdist.bernoulli_log_prob(jnp.asarray(x), a), prob)
