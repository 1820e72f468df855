"""PyTorch port: the spatial transformer's backward against the JAX package.

``st_gather_bwd_plain`` (the backward kernel's plain twin, which the CPU
path runs) against ``jax.vjp`` of the XLA gather and of the Pallas gather
in interpret mode, whose backward is ``_gather_bwd_kernel``; the autograd
Function's CPU backward against autograd through the plain forward; and
the weight derivatives against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch.ops import spatial_transformer as tst
from attend_infer_repeat_torch.ops import st_kernel
from attend_infer_repeat_tpu.ops import pallas_st
from attend_infer_repeat_tpu.ops import spatial_transformer as jst

torch.set_num_threads(1)

# f32 accumulation order differs from both JAX paths; the z_where grads
# sum O(out·in) products (the Pallas kernel's own test, test_pallas_st.py)
TOL = dict(rtol=1e-3, atol=1e-4)


def inputs(n, in_shape, out_shape, seed, paste=False):
    rng = np.random.default_rng(seed)
    img = rng.random((n,) + tuple(in_shape), dtype=np.float32)
    zw = np.concatenate([rng.uniform(0.2, 1.2, (n, 2)),
                         rng.uniform(-0.8, 0.8, (n, 2))], 1).astype(np.float32)
    if paste:
        zw = np.asarray(jst.invert_where(jnp.asarray(zw)))
    g = rng.normal(size=(n,) + tuple(out_shape)).astype(np.float32)
    return img, zw, g


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def jax_vjp(fn, img, zw, g):
    _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(zw))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


CASES = {  # n, input, output, paste through invert_where
    "gather_n3": (3, (50, 50), (20, 20), False),
    "gather_n17": (17, (50, 50), (20, 20), False),
    "paste_n3": (3, (20, 20), (50, 50), True),
    "paste_n17": (17, (20, 20), (50, 50), True),
    "odd_shape": (5, (25, 31), (9, 13), False),
    "one_row": (4, (1, 40), (1, 7), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_xla_and_pallas(case):
    n, in_shape, out_shape, paste = CASES[case]
    img, zw, g = inputs(n, in_shape, out_shape, n, paste)
    g_img, g_zw = st_kernel.st_gather_bwd_plain(t(img), t(zw), t(g),
                                                out_shape)
    xla = jax_vjp(lambda i, z: jst.st_gather(i, z, out_shape), img, zw, g)
    pal = jax_vjp(lambda i, z: pallas_st.st_gather_pallas(
        i, z, out_shape, 8, True), img, zw, g)
    for ref in (xla, pal):
        np.testing.assert_allclose(g_img.numpy(), ref[0], **TOL)
        np.testing.assert_allclose(g_zw.numpy(), ref[1], **TOL)
    # g_img may be skipped; g_zw does not change
    none, g_zw2 = st_kernel.st_gather_bwd_plain(t(img), t(zw), t(g),
                                                out_shape, need_img=False)
    assert none is None and torch.equal(g_zw2, g_zw)


def test_plain_backward_huge_coordinates_are_zero_like_jax():
    """Near-zero scales through invert_where put every sample ~1e7 pixels
    away: both gradients are exactly 0 in both packages."""
    _, _, g = inputs(2, (20, 20), (50, 50), 0)
    img = np.random.default_rng(1).random((2, 20, 20), dtype=np.float32)
    zw = np.asarray(jst.invert_where(jnp.asarray(
        [[0.0, 0.0, 0.01, 0.01], [1e-9, -1e-9, 0.0, 0.0]], jnp.float32)))
    g_img, g_zw = st_kernel.st_gather_bwd_plain(t(img), t(zw), t(g),
                                                (50, 50))
    assert torch.equal(g_img, torch.zeros_like(g_img))
    assert torch.equal(g_zw, torch.zeros_like(g_zw))
    pal = jax_vjp(lambda i, z: pallas_st.st_gather_pallas(
        i, z, (50, 50), 8, True), img, zw, g)
    np.testing.assert_array_equal(pal[0], 0.0)
    np.testing.assert_array_equal(pal[1], 0.0)


def test_plain_backward_bf16_matches_pallas_bf16():
    """bf16 mode: the operands of each contraction rounded as the Pallas
    kernel's dot() rounds them.  Held to test_pallas_st.py's bound,
    relative to the gradient's scale (z_where grads sum hundreds of
    bf16-rounded products with cancellation)."""
    img, zw, g = inputs(8, (50, 50), (20, 20), 42)
    got = st_kernel.st_gather_bwd_plain(t(img), t(zw), t(g), (20, 20),
                                        "bfloat16")
    pal = jax_vjp(lambda i, z: pallas_st.st_gather_pallas(
        i, z, (20, 20), 8, True, "bfloat16"), img, zw, g)
    f32 = st_kernel.st_gather_bwd_plain(t(img), t(zw), t(g), (20, 20))
    for a, b, c in zip(got, pal, f32):
        a = a.numpy()
        for ref in (b, c.numpy()):
            np.testing.assert_allclose(a, ref, rtol=5e-2,
                                       atol=2e-2 * max(np.abs(ref).max(), 1))
    # the rounding is real: bf16 differs from f32
    assert not torch.equal(got[1], f32[1])


@pytest.mark.parametrize("paste", [False, True])
def test_function_cpu_backward_matches_autograd_of_plain_forward(paste):
    """STGather's CPU backward is the explicit VJP, not autograd's
    derivative of the einsum; the two agree to f32 roundoff (1e-5 of the
    gradient's scale)."""
    in_shape, out_shape = ((20, 20), (50, 50)) if paste else ((50, 50),
                                                              (20, 20))
    img, zw, g = inputs(6, in_shape, out_shape, 5, paste)
    a_img, a_zw = t(img).requires_grad_(), t(zw).requires_grad_()
    tst.st_gather(a_img, a_zw, out_shape).backward(t(g))
    b_img, b_zw = t(img).requires_grad_(), t(zw).requires_grad_()
    st_kernel.st_gather_plain(b_img, b_zw, out_shape).backward(t(g))
    for a, b in ((a_img.grad, b_img.grad), (a_zw.grad, b_zw.grad)):
        scale = max(b.abs().max().item(), 1.0)
        assert (a - b).abs().max().item() <= 1e-5 * scale


def test_function_skips_the_image_gradient_when_not_needed():
    img, zw, g = inputs(3, (30, 30), (12, 12), 7)
    tz = t(zw).requires_grad_()
    ti = t(img)                                # data: no gradient wanted
    tst.st_gather(ti, tz, (12, 12)).backward(t(g))
    _, g_zw = st_kernel.st_gather_bwd_plain(t(img), t(zw), t(g), (12, 12))
    assert ti.grad is None and torch.equal(tz.grad, g_zw)
    # the paste's gradient reaches z_where through invert_where
    ze = t(zw).requires_grad_()
    tst.st_paste(t(g), ze, (30, 30)).sum().backward()
    _, vjp = jax.vjp(lambda z: jst.st_paste(jnp.asarray(g), z, (30, 30)),
                     jnp.asarray(zw))
    (ref,) = vjp(jnp.ones((3, 30, 30), jnp.float32))
    np.testing.assert_allclose(ze.grad.numpy(), np.asarray(ref), **TOL)


def test_axis_weights_and_dp_match_jax():
    """Weights, dW/dp and u against the Pallas helper; the weights equal
    the forward's (``_axis_weights``) bit for bit."""
    _, zw, _ = inputs(5, (1, 1), (1, 1), 9)
    for (scale, shift), (out_n, in_n) in (((0, 2), (7, 30)),
                                          ((1, 3), (9, 40))):
        w, dw, u = tst._axis_weights_and_dp(t(zw[:, scale]), t(zw[:, shift]),
                                            out_n, in_n)
        jw, jdw, ju = pallas_st._axis_weights_and_dp(
            jnp.asarray(zw[:, scale]), jnp.asarray(zw[:, shift]), out_n, in_n)
        # JAX computes p with other roundings; positions ~40 carry f32
        # steps of 4e-6, and dW/dp can only flip where |p - q| is that close
        # to 0 or 1, which these draws avoid
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)
        np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw))
        np.testing.assert_allclose(u.numpy(), np.asarray(ju)[0], atol=1e-7)
        assert torch.equal(w, tst._axis_weights(t(zw[:, scale]),
                                                t(zw[:, shift]), out_n, in_n))
    assert set(np.unique(dw.numpy())) <= {-1.0, 0.0, 1.0}
