"""PyTorch port: each module on weights converted from flax against
``flax.apply``, in f32 and in the bf16 mix; the parameter layout and the
initialization against flax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from attend_infer_repeat_torch.convert import params_from_flax
from attend_infer_repeat_torch.models import modules as tm
from attend_infer_repeat_tpu.models import modules as jm
from torch_parity import (
    FAST,
    JaxAIR,
    jax_params,
    model_configs,
    paired_models,
    to_numpy_tree,
)

torch.set_num_threads(1)

# where each module's parameters sit in the model: flax path, port prefix
WRAP = {
    "Encoder": (("cell", "Encoder_0"), "cell.encoder."),
    "StochasticTransformParam": (("cell", "StochasticTransformParam_0"),
                                 "cell.where."),
    "GlimpseEncoder": (("cell", "GlimpseEncoder_0"), "cell.what."),
    "StepsPredictor": (("cell", "StepsPredictor_0"), "cell.steps."),
    "GlimpseDecoder": (("decoder",), "decoder."),
    "BaselineMLP": (("baseline",), "baseline."),
    "LSTMCell": (("cell", "OptimizedLSTMCell_0"), "cell.lstm."),
}
DTYPES = {"f32": {}, "bf16": dict(dtype="bfloat16")}
# f32: roundoff; bf16: one bf16 rounding of the outputs (2^-8 relative)
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def load(module, flax_params, name):
    """Load flax ``params`` of one submodule into the port's ``module``."""
    path, prefix = WRAP[name]
    tree = to_numpy_tree(flax_params["params"])
    for key in reversed(path):
        tree = {key: tree}
    sd = {k[len(prefix):]: v for k, v in params_from_flax(tree).items()}
    module.load_state_dict(sd)
    return module


def x_np(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def check(out_t, out_j, tol):
    if isinstance(out_t, tuple):
        for a, b in zip(out_t, out_j):
            check(a, b, tol)
        return
    np.testing.assert_allclose(out_t.detach().float().numpy(),
                               np.asarray(out_j, np.float32), **tol)


@pytest.mark.parametrize("mix", sorted(DTYPES))
@pytest.mark.parametrize("name, n_in", [
    ("Encoder", 24 * 24), ("StochasticTransformParam", 32),
    ("GlimpseEncoder", 100), ("StepsPredictor", 32 + 4 + 2 * 8)])
def test_module_matches_flax(name, n_in, mix):
    jc, tc = model_configs(**DTYPES[mix])
    x = x_np((6, n_in))
    if name == "Encoder":
        x = np.abs(x).reshape(6, 24, 24)
    jmod = getattr(jm, name)(jc)
    params = jmod.init(jax.random.key(0), jnp.asarray(x))
    tmod = (tm.StepsPredictor(tc, n_in) if name == "StepsPredictor"
            else getattr(tm, name)(tc))
    load(tmod, params, name)
    with torch.no_grad():
        out_t = tmod(torch.from_numpy(x))
    check(out_t, jmod.apply(params, jnp.asarray(x)), TOL[mix])


@pytest.mark.parametrize("mix", ["f32", "bf16 decoder"])
def test_decoder_matches_flax(mix):
    sw = {} if mix == "f32" else dict(dtype="float32",
                                      decoder_dtype="bfloat16")
    jc, tc = model_configs(**sw)
    z = x_np((5, 3, 8))
    jmod = jm.GlimpseDecoder(jc)
    params = jmod.init(jax.random.key(1), jnp.asarray(z))
    tmod = load(tm.GlimpseDecoder(tc), params, "GlimpseDecoder")
    with torch.no_grad():
        out = tmod(torch.from_numpy(z))
    assert out.shape == (5, 3, 10, 10)
    check(out, jmod.apply(params, jnp.asarray(z)), TOL["f32" if mix == "f32"
                                                        else "bf16"])


@pytest.mark.parametrize("mix", sorted(DTYPES))
def test_baseline_matches_flax(mix):
    jc, tc = model_configs(**DTYPES[mix])
    img, feats = np.abs(x_np((4, 576))), x_np((4, 3, 19), 1)
    jmod = jm.BaselineMLP(jc)
    params = jmod.init(jax.random.key(2), jnp.asarray(img),
                       jnp.asarray(feats))
    tmod = tm.BaselineMLP(tc, 19)
    load(tmod, params, "BaselineMLP")
    with torch.no_grad():
        out = tmod(torch.from_numpy(img), torch.from_numpy(feats))
    assert out.shape == (4, 3)
    check(out, jmod.apply(params, jnp.asarray(img), jnp.asarray(feats)),
          TOL[mix])


def test_lstm_matches_flax():
    x, h, c = x_np((5, 45)), x_np((5, 32), 1), x_np((5, 32), 2)
    cell = fnn.OptimizedLSTMCell(32)
    params = cell.init(jax.random.key(3), (jnp.asarray(c), jnp.asarray(h)),
                       jnp.asarray(x))
    (jc_, jh_), jy = cell.apply(params, (jnp.asarray(c), jnp.asarray(h)),
                                jnp.asarray(x))
    tcell = load(tm.LSTMCell(45, 32), params, "LSTMCell")
    with torch.no_grad():
        (tc_, th_), ty = tcell((torch.from_numpy(c), torch.from_numpy(h)),
                               torch.from_numpy(x))
    for a, b in ((tc_, jc_), (th_, jh_), (ty, jy)):
        check(a, b, TOL["f32"])


def test_where_helpers_and_true_clip():
    for iso in (False, True):
        jc, tc = model_configs(isotropic_scale=iso, max_scale=0.45)
        assert tm.where_param_indices(tc) == jm.where_param_indices(jc)
        z = x_np((4, 3 if iso else 4))
        check(tm.expand_where(tc, torch.from_numpy(z)),
              jm.expand_where(jc, jnp.asarray(z)), TOL["f32"])
    zw = torch.tensor([[0.3, 0.6, 0.5, -0.5], [0.9, 0.1, 0.0, 0.0]],
                      requires_grad=True)
    out = tm.st_where(tc, zw)
    check(out, jm.st_where(jc, jnp.asarray(zw.detach().numpy())), TOL["f32"])
    out.sum().backward()
    # scales past the cap get zero gradient; the shifts pass through
    assert zw.grad.tolist() == [[1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 1.0, 1.0]]


def conv_stem_case(mix, size, seed=0):
    """The encoder with ``encoder_conv=(4, 8)`` at ``size`` in both
    packages, on flax's weights: (port output, flax output)."""
    jc, tc = model_configs(img_size=size, encoder_conv=(4, 8), **DTYPES[mix])
    x = np.abs(x_np((5,) + size, seed))
    jmod = jm.Encoder(jc)
    params = jmod.init(jax.random.key(seed), jnp.asarray(x))
    tmod = load(tm.Encoder(tc), params, "Encoder")
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    return out, jmod.apply(params, jnp.asarray(x))


def test_conv_stem_not_ported():
    """Kept under its old name, from when the stem raised: the stem at
    24×24 in f32 against flax (flax pads 'SAME' as (0, 1) there), and its
    layout: (out, in, 3, 3) kernels ahead of the MLP, in the state_dict."""
    out, ref = conv_stem_case("f32", (24, 24))
    assert out.shape == (5, 32)
    check(out, ref, TOL["f32"])
    _, tc = model_configs(encoder_conv=(4, 8))
    shapes = {k: tuple(v.shape) for k, v in tm.Encoder(tc).state_dict().items()}
    assert shapes["conv.0.weight"] == (4, 1, 3, 3)
    assert shapes["conv.1.weight"] == (8, 4, 3, 3)
    assert shapes["mlp.dense.0.weight"] == (32, 6 * 6 * 8)


@pytest.mark.parametrize("mix", sorted(DTYPES))
@pytest.mark.parametrize("size", [(24, 24), (25, 31)], ids=["24x24", "25x31"])
def test_conv_stem_matches_flax(size, mix):
    """Even and odd sides: flax 'SAME' pads (0, 1) at an even side and
    (1, 1) at 25 and 31 (and at 13 in the second layer)."""
    out, ref = conv_stem_case(mix, size, seed=1)
    check(out, ref, TOL[mix])


def test_same_padding_is_flax_same():
    for n in range(1, 60):
        lo, hi = tm.same_padding(n)
        want = jax.lax.padtype_to_pads((n,), (3,), (2,), "SAME")[0]
        assert (lo, hi) == tuple(want), n
    assert tm.same_padding(50) == (0, 1) and tm.same_padding(25) == (1, 1)


@pytest.mark.parametrize("switches", [{}, FAST], ids=["serving", "fast"])
def test_state_dict_layout_matches_converted_flax(switches):
    """Every port parameter has a flax counterpart of the same shape."""
    jmodel, params, tmodel = paired_models(use_baseline=True, **switches)
    conv = params_from_flax(to_numpy_tree(params))
    ours = tmodel.state_dict()
    assert sorted(conv) == sorted(ours)
    assert all(conv[k].shape == ours[k].shape for k in ours)


def test_init_follows_flax():
    """Same initializer families as flax: truncated lecun-normal weights,
    zero biases, orthogonal recurrent blocks, steps_bias on the logit."""
    from attend_infer_repeat_torch.models.air import AIRModel

    jc, tc = model_configs(rnn_hidden=64)
    model = AIRModel(tc, use_baseline=True, device="cpu", seed=0)
    conv = params_from_flax(to_numpy_tree(jax_params(JaxAIR(jc))))
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("bias"):
            want = (tc.steps_bias if k == "cell.steps.logit.bias" else 0.0)
            assert torch.all(v == want), k
            assert torch.all(conv[k] == want), k
        elif k == "cell.lstm.hh.weight":
            for block in v.chunk(4, 0):
                torch.testing.assert_close(block @ block.t(), torch.eye(64),
                                           atol=1e-5, rtol=0)
        else:
            bound = 2.0 / np.sqrt(v.shape[1]) / 0.87962566103423978
            assert float(v.abs().max()) <= bound * (1 + 1e-6), k
            assert float(conv[k].abs().max()) <= bound * (1 + 1e-6), k
    big = sd["cell.encoder.mlp.dense.0.weight"]
    assert abs(float(big.std()) * np.sqrt(576) - 1.0) < 0.05
    assert abs(float(conv["cell.encoder.mlp.dense.0.weight"].std())
               * np.sqrt(576) - 1.0) < 0.05
    again = AIRModel(tc, use_baseline=True, device="cpu", seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
