"""PyTorch port: every ``AIROutputs`` field against the JAX model on the
same weights and the same noise (the JAX draws regenerated from its key)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    FAST,
    binarized_presence,
    forward_noise,
    generate_noise,
    images,
    paired_models,
)

torch.set_num_threads(1)

FIELDS = ("elbo", "log_likelihood", "kl_what", "kl_where", "kl_steps",
          "canvas", "glimpses", "num_steps_pmf", "expected_steps",
          "baseline")
STEP_FIELDS = ("where_loc", "where_scale", "z_where", "what_loc",
               "what_scale", "z_what", "pres_prob", "glimpse")
EXACT = ("predicted_steps", "mode_steps")
EXACT_STEPS = ("pres", "pres_prev")

# f32 switches: roundoff (ELBO to rtol 1e-5); the canonical_fast mix runs
# its networks in bf16 in both packages, rounded at different places
TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
CASES = {
    "serving": ({}, "f32"),
    "canvas_rebuild": (dict(canvas_rebuild=True), "f32"),
    "canonical_fast": (FAST, "bf16"),
    "canonical_fast_rebuild": (dict(FAST, canvas_rebuild=True), "bf16"),
    "conv_stem": (dict(encoder_conv=(4, 8)), "f32"),
}


def run_both(switches, batch=8, seed=3, prior=0.3):
    jm, params, tm = paired_models(use_baseline=True, **switches)
    x = images(batch, seed=seed)
    key = jax.random.key(seed)
    binarize = switches.get("explore_eps") is not None
    if binarize:
        with binarized_presence():
            jo = jm.apply(params, jnp.asarray(x), key, prior)
    else:
        jo = jm.apply(params, jnp.asarray(x), key, prior)
    noise = forward_noise(jm.cfg, key, batch, binarize=binarize)
    with torch.no_grad():
        to = tm(torch.from_numpy(x), prior, noise=noise)
    return jo, to


def close(a, b, tol, what):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), err_msg=what,
                               **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    switches, mix = CASES[case]
    jo, to = run_both(switches)
    for f in FIELDS:
        close(getattr(to, f), getattr(jo, f), TOL[mix], f)
    for f in STEP_FIELDS:
        close(getattr(to.steps, f), getattr(jo.steps, f), TOL[mix], f)
    if mix == "f32":
        close(to.elbo, jo.elbo, dict(rtol=1e-5, atol=0), "elbo")
    for f in EXACT:
        assert np.array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)))
    for f in EXACT_STEPS:
        assert np.array_equal(getattr(to.steps, f).numpy(),
                              np.asarray(getattr(jo.steps, f))), f
    assert to.canvas.dtype == torch.float32
    assert to.steps.z_where.shape == (8, 3, 4)


def test_generator_noise_is_seeded_and_well_formed():
    _, _, tm = paired_models(use_baseline=False)
    x = torch.from_numpy(images(4))
    outs = [tm(x, 0.5, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(outs[0].elbo, outs[1].elbo)
    assert not torch.equal(outs[0].elbo, outs[2].elbo)
    assert outs[0].baseline is None
    o = outs[0]
    assert o.num_steps_pmf.shape == (4, 4)
    torch.testing.assert_close(o.num_steps_pmf.sum(-1), torch.ones(4))
    assert bool(torch.isfinite(o.elbo).all())
    assert set(o.steps.pres.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("case", ["serving", "canonical_fast"])
def test_generate_matches_jax(case):
    from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR

    switches, mix = CASES[case]
    jm, params, tm = paired_models(use_baseline=False, **switches)
    key = jax.random.key(11)
    ref = jm.apply(params, key, 6, 0.7, method=JaxAIR.generate)
    noise = generate_noise(jm.cfg, key, 6, 0.7)
    with torch.no_grad():
        out = tm.generate(6, 0.7, noise=noise)
    close(out, ref, TOL["f32"], "generate")
    with torch.no_grad():
        a = tm.generate(5, 1.0, generator=torch.Generator().manual_seed(0))
    assert a.shape == (5, 24, 24) and bool(torch.isfinite(a).all())


def test_outputs_cover_the_jax_fields():
    from attend_infer_repeat_tpu.models.air import AIROutputs as J
    from attend_infer_repeat_torch.models.air import AIROutputs as T

    assert [f.name for f in dataclasses.fields(T)] == \
        [f.name for f in dataclasses.fields(J)]
