"""Shared fixtures for the PyTorch port's parity tests against the JAX package.

Tiny model widths, flax initialization converted to the port's weights,
and the JAX model's noise regenerated from its key so that both packages
consume the same draws.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.convert import params_from_flax
from attend_infer_repeat_torch.models.air import AIRModel as TorchAIR
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR
from helpers.torch_uncaptured import UncapturedGraph

TINY = dict(img_size=(24, 24), glimpse_size=(10, 10), n_what=8, max_steps=3,
            rnn_hidden=32, encoder_hidden=(32,),
            glimpse_encoder_hidden=(32,), decoder_hidden=(32,),
            transform_hidden=(32,), steps_hidden=(16,),
            baseline_hidden=(32, 32))

# the switches of the `canonical_fast` model: the bf16 compute mix with an
# f32 decoder, a bf16 canvas carry, isotropic windows and a scale cap
FAST = dict(explore_eps=0.05, output_std=0.15,
            where_prior_scale=(0.03, 0.03, 1.0, 1.0), isotropic_scale=True,
            max_scale=0.45, dtype="bfloat16", decoder_dtype="float32",
            canvas_carry_dtype="bfloat16")


def model_configs(**switches):
    """The same tiny ``ModelConfig`` in both packages."""
    kw = dict(TINY, **switches)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def jax_params(jm, batch_shape=(2, 24, 24), seed=0):
    return jm.init(jax.random.key(seed), jnp.zeros(batch_shape),
                   jax.random.key(1), 0.5)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def paired_models(use_baseline=False, **switches):
    """(flax model, flax params, port model on CPU with the same weights)."""
    jc, tc = model_configs(**switches)
    jm = JaxAIR(jc, use_baseline=use_baseline)
    params = jax_params(jm, (2,) + tuple(jc.img_size))
    tm = TorchAIR(tc, use_baseline=use_baseline, device="cpu")
    tm.load_state_dict(params_from_flax(to_numpy_tree(params)))
    return jm, params, tm


def images(batch, size=(24, 24), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((batch,) + tuple(size)) *
            (rng.random((batch,) + tuple(size)) > 0.6)).astype(np.float32)


def binarize_u(u):
    """Presence uniforms moved to {0.001, 0.999}: with explore_eps=0.05 the
    presence probability lies in [0.05, 0.95], so no sample can flip."""
    return jnp.where(u < 0.5, 0.001, 0.999).astype(u.dtype)


@contextlib.contextmanager
def binarized_presence():
    orig = jax.random.uniform
    with mock.patch.object(jax.random, "uniform",
                           lambda k, shape, *a, **kw: binarize_u(
                               orig(k, shape, *a, **kw))):
        yield


def forward_noise(jc, key, batch, binarize=False):
    """The JAX forward's draws, regenerated from its key, as torch tensors
    ``(eps_where (T,B,d), eps_what (T,B,n_what), u_pres (T,B,1))``."""
    d_where = 3 if jc.isotropic_scale else 4
    ew, eh, up = [], [], []
    for k in jax.random.split(key, jc.max_steps):
        k_where, k_what, k_pres = jax.random.split(k, 3)
        ew.append(jax.random.normal(k_where, (batch, d_where)))
        eh.append(jax.random.normal(k_what, (batch, jc.n_what)))
        u = jax.random.uniform(k_pres, (batch, 1))
        up.append(binarize_u(u) if binarize else u)
    return tuple(torch.from_numpy(np.array(jnp.stack(a)))
                 for a in (ew, eh, up))


def synth_draws(key, cfg, batch, n_bank):
    """The JAX synthesizer's draws for either placement, regenerated from
    its key as ``synthesize_batch`` and its ``_grid_positions`` or
    ``_uniform_positions`` split it; torch tensors keyed as the port's
    ``sample_draws`` returns them."""
    from attend_infer_repeat_tpu.data import synth as jsynth

    t_slots = max(cfg.max_digits, 1)
    k_count, k_idx, k_scale, k_pos = jax.random.split(key, 4)
    lo, hi = cfg.scale_range
    draws = {
        "nums": jax.random.randint(k_count, (batch,), cfg.min_digits,
                                   cfg.max_digits + 1),
        "idx": jax.random.randint(k_idx, (batch, t_slots), 0, n_bank),
        "scale": jax.random.uniform(k_scale, (batch, t_slots), minval=lo,
                                    maxval=hi),
    }
    if cfg.placement == "uniform":
        draws["candidates"] = jax.random.uniform(
            k_pos, (batch, t_slots, cfg.place_attempts, 2), minval=-1.0,
            maxval=1.0)
    else:
        g = jsynth._grid_size(t_slots, cfg)
        k_cell, k_jit = jax.random.split(k_pos)
        draws["scores"] = jax.random.uniform(k_cell, (batch, g * g))
        draws["jitter"] = jax.random.uniform(k_jit, (batch, t_slots, 2),
                                             minval=-1.0, maxval=1.0)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def generate_noise(jc, key, batch, success_prob):
    """The JAX ``generate``'s draws ``(n, eps_what, eps_where)``."""
    from attend_infer_repeat_tpu.ops.distributions import geometric_prior

    d_where = 3 if jc.isotropic_scale else 4
    k_n, k_what, k_where = jax.random.split(key, 3)
    pmf = geometric_prior(success_prob, jc.max_steps)
    n = jax.random.categorical(k_n, jnp.log(pmf + 1e-20), shape=(batch,))
    eps_what = jax.random.normal(k_what, (batch, jc.max_steps, jc.n_what))
    eps_where = jax.random.normal(k_where, (batch, jc.max_steps, d_where))
    return tuple(torch.from_numpy(np.array(a))
                 for a in (n, eps_what, eps_where))


@pytest.fixture
def uncaptured(monkeypatch):
    """The entry points take their graphed path on the CPU, with the
    capture stubbed out (``UncapturedGraph``); inside
    ``utils.debug_mode`` they run eagerly as ever."""
    UncapturedGraph.install(monkeypatch)


def eager_mode():
    """``utils.debug_mode`` without the NaN trap: the eager path."""
    from attend_infer_repeat_torch.utils import debug_mode

    return debug_mode(nans=False)


def assert_bit_equal(got, want, what=""):
    """Two nests of tensors (tuples, lists, dicts, dataclasses) equal bit
    for bit, leaf by leaf."""
    from attend_infer_repeat_torch.utils import graphs

    a, b = graphs.leaves(got), graphs.leaves(want)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, i)
