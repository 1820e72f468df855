"""PyTorch port: the spatial transformer against the JAX package (einsum
path and the Pallas kernel in interpret mode), the 4-tap oracle, edge
cases, the plain VJP, and the kernel module's CPU-side contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch.ops import spatial_transformer as tst
from attend_infer_repeat_torch.ops import st_kernel
from attend_infer_repeat_tpu.ops import spatial_transformer as jst
from attend_infer_repeat_tpu.ops.pallas_st import (
    st_gather_pallas,
    st_paste_pallas,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def inputs(batch_shape, in_shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(batch_shape))
    img = rng.random(tuple(batch_shape) + tuple(in_shape), dtype=np.float32)
    zw = np.concatenate([rng.uniform(0.2, 1.2, (n, 2)),
                         rng.uniform(-0.8, 0.8, (n, 2))], 1)
    return img, zw.astype(np.float32).reshape(tuple(batch_shape) + (4,))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("batch", [1, 5, 8, 17])
def test_gather_matches_jax_and_pallas(batch):
    img, zw = inputs((batch,), (50, 50), batch)
    out = tst.st_gather(t(img), t(zw), (20, 20)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jst.st_gather(jnp.asarray(img), jnp.asarray(zw),
                                      (20, 20))), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(st_gather_pallas(jnp.asarray(img), jnp.asarray(zw),
                                         (20, 20), 8, True)), **TOL)


def test_gather_multidim_batch():
    img, zw = inputs((3, 4), (30, 30), 0)
    out = tst.st_gather(t(img), t(zw), (12, 12))
    assert out.shape == (3, 4, 12, 12)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(st_gather_pallas(
            jnp.asarray(img), jnp.asarray(zw), (12, 12), 8, True)), **TOL)


@pytest.mark.parametrize("batch", [1, 6])
def test_paste_matches_jax_and_pallas(batch):
    g, zw = inputs((batch,), (20, 20), 3 + batch)
    out = tst.st_paste(t(g), t(zw), (50, 50)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jst.st_paste(jnp.asarray(g), jnp.asarray(zw),
                                     (50, 50))), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(st_paste_pallas(jnp.asarray(g), jnp.asarray(zw),
                                        (50, 50), 8, True)), **TOL)


def test_bf16_mode_matches_pallas_bf16():
    img, zw = inputs((8,), (50, 50), 42)
    out = st_kernel.st_gather_plain(t(img), t(zw), (20, 20), "bfloat16")
    assert out.dtype == torch.float32
    ref = np.asarray(st_gather_pallas(jnp.asarray(img), jnp.asarray(zw),
                                      (20, 20), 8, True, "bfloat16"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2, atol=2e-2)
    f32 = tst.st_gather(t(img), t(zw), (20, 20))
    np.testing.assert_allclose(out.numpy(), f32.numpy(), rtol=2e-2, atol=2e-2)


def test_invert_where_matches_jax_including_eps_sign():
    zw = np.array([[0.5, -0.25, 0.3, -0.1], [0.0, -0.0, 0.2, 0.2],
                   [1e-9, -1e-9, 0.0, 1.0], [-2.0, 3.0, 0.0, 0.0]],
                  np.float32)
    np.testing.assert_allclose(
        tst.invert_where(t(zw)).numpy(),
        np.asarray(jst.invert_where(jnp.asarray(zw))), rtol=1e-6)


def test_weights_match_jax():
    # the port computes u = 2k/(out-1) - 1 as the kernel does, JAX uses
    # linspace; positions p ~ 40 carry f32 steps of 4e-6
    _, zw = inputs((5,), (1, 1), 9)
    for a, b in zip(tst.st_weights(t(zw), (7, 9), (30, 40)),
                    jst.st_weights(jnp.asarray(zw), (7, 9), (30, 40))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_out_of_bounds_gives_zero():
    img = torch.ones((2, 20, 20))
    zw = torch.tensor([[0.5, 0.5, 5.0, 5.0], [0.5, 0.5, -5.0, -5.0]])
    assert torch.equal(tst.st_gather(img, zw, (8, 8)), torch.zeros(2, 8, 8))


def test_near_zero_scale_paste_is_finite_and_zero():
    g = torch.rand((2, 20, 20), generator=torch.Generator().manual_seed(0))
    zw = torch.tensor([[0.0, 0.0, 0.01, 0.01], [1e-9, -1e-9, 0.0, 0.0]])
    out = tst.st_paste(g, zw, (50, 50))
    assert bool(torch.isfinite(out).all()) and out.abs().max().item() == 0.0
    ref = jst.st_paste(jnp.asarray(g.numpy()), jnp.asarray(zw.numpy()),
                       (50, 50))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_matches_4tap_oracle():
    img, zw = inputs((6,), (25, 31), 11)
    oracle = tst.st_gather_reference(t(img), t(zw), (9, 13))
    np.testing.assert_allclose(
        tst.st_gather(t(img), t(zw), (9, 13)).numpy(), oracle.numpy(), **TOL)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(jst.st_gather_reference(
            jnp.asarray(img), jnp.asarray(zw), (9, 13))), **TOL)


def test_plain_vjp_matches_jax():
    img, zw = inputs((4,), (25, 25), 7)
    cot = np.random.default_rng(8).normal(size=(4, 10, 10)).astype(np.float32)
    ti = t(img).requires_grad_()
    tz = t(zw).requires_grad_()
    tst.st_gather(ti, tz, (10, 10)).backward(t(cot))
    _, vjp = jax.vjp(lambda i, z: jst.st_gather(i, z, (10, 10)),
                     jnp.asarray(img), jnp.asarray(zw))
    g_img, g_zw = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(g_img),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(g_zw),
                               rtol=1e-4, atol=1e-4)


def test_kernel_module_on_cpu():
    """The kernel's module imports without nvcc; its CUDA wrapper refuses
    CPU tensors, and CPU calls run the plain version without launching."""
    before = st_kernel.launches
    img, zw = t(np.ones((2, 5, 5))), t([[1, 1, 0, 0]] * 2)
    with pytest.raises(ValueError, match="CUDA"):
        st_kernel.st_gather_cuda(img, zw, (3, 3))
    with pytest.raises(ValueError, match="compute_dtype"):
        st_kernel.st_gather_plain(img, zw, (3, 3), "float16")
    tst.st_gather(img, zw, (3, 3))
    assert st_kernel.launches == before
    assert st_kernel.SOURCE.is_file()
    assert "extern \"C\" int st_gather(" in st_kernel.SOURCE.read_text()


@pytest.mark.parametrize("in_shape,out_shape,paste",
                         [((50, 50), (20, 20), False),
                          ((20, 20), (50, 50), True)])
def test_chip_smoke_gather_work_counts_touched_pixels(in_shape, out_shape,
                                                      paste):
    """The card check's bound counts the input pixels the gather depends
    on (where the plain gather's gradient is nonzero), by 32-byte sector."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    img, zw = inputs((7,), in_shape, 3)
    zw = tst.invert_where(t(zw)) if paste else t(zw)
    ti = t(img).requires_grad_()
    st_kernel.st_gather_plain(ti, zw, out_shape).sum().backward()
    needed = (ti.grad != 0).flatten()
    nbytes, flops, touched = chip_smoke.gather_work(zw, in_shape, out_shape)
    sectors = torch.unique(needed.nonzero()[:, 0] // 8).numel()
    n, (h, w) = zw.shape[0], out_shape
    assert 0 < touched < 1
    assert touched == needed.sum().item() / needed.numel()
    assert nbytes == 32 * sectors + 4 * n * (4 + h * w)
    w_y, w_x = tst.st_weights(zw, out_shape, in_shape)
    taps = torch.einsum("niq,njr->", (w_y != 0).float(), (w_x != 0).float())
    assert flops == 2 * taps.item()
