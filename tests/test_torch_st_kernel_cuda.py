"""PyTorch port: the hand-written gather kernel and its backward on the
card, against their plain PyTorch versions on the same inputs.

Needs a CUDA card and ``nvcc``; every test skips without a card.  The
kernels have no CPU mode, so these run only on the card, without the JAX
package's conftest (the card's machine has no JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_st_kernel_cuda.py

Each kernel rounds where its plain version rounds, so both modes are held
to the same limits, and a kernel that skipped a bf16 rounding (about 4e-3
relative) fails them.  Forward: max abs error 1e-5 in f32 and 1e-3 in
bf16 mode (well under one bf16 ulp of a pixel).  Backward: g_img to 1e-5
and g_zw to 1e-4 of max(1, max|plain|) (each g_zw sums thousands of
products with cancellation, in another order than the plain matmuls).
The fused paste (paste, presence mask, f32 add and cast to the carry in
one kernel) does the unfused ops' arithmetic, so it is held to them bit
for bit, forward and backward.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from attend_infer_repeat_torch.ops import spatial_transformer as tst
from attend_infer_repeat_torch.ops import st_kernel
from attend_infer_repeat_torch.utils import graphs

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-5, "bfloat16": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(n, in_shape, seed, paste=False):
    rng = np.random.default_rng(seed)
    img = rng.random((n,) + tuple(in_shape), dtype=np.float32)
    zw = np.concatenate([rng.uniform(0.2, 1.2, (n, 2)),
                         rng.uniform(-0.8, 0.8, (n, 2))], 1)
    img, zw = torch.from_numpy(img), torch.from_numpy(zw.astype(np.float32))
    if paste:
        zw = tst.invert_where(zw)
    return img.cuda(), zw.cuda().contiguous()


def max_err(a, b):
    torch.cuda.synchronize()
    return (a - b).abs().max().item()


@pytest.mark.parametrize("mode", sorted(TOL))
@pytest.mark.parametrize("n, in_shape, out_shape, paste", [
    (1, (50, 50), (20, 20), False),
    (5, (50, 50), (20, 20), False),
    (8191, (50, 50), (20, 20), False),
    (17, (20, 20), (50, 50), True),
    (8191, (20, 20), (50, 50), True),
    (33, (16, 16), (50, 50), True),
    (7, (25, 31), (9, 13), False),
    (3, (1, 40), (1, 7), False),
])
def test_kernel_matches_plain(cuda, mode, n, in_shape, out_shape, paste):
    img, zw = inputs(n, in_shape, n, paste)
    out = st_kernel.st_gather_cuda(img, zw, out_shape, mode)
    assert out.shape == (n,) + out_shape and out.dtype == torch.float32
    assert max_err(out, st_kernel.st_gather_plain(img, zw, out_shape,
                                                  mode)) <= TOL[mode]


def test_kernel_matches_4tap_oracle(cuda):
    img, zw = inputs(64, (50, 50), 3)
    assert max_err(st_kernel.st_gather_cuda(img, zw, (20, 20)),
                   tst.st_gather_reference(img, zw, (20, 20))) <= 1e-5


def test_out_of_bounds_is_exactly_zero(cuda):
    img = torch.ones((4, 20, 20), device=cuda)
    zw = torch.tensor([[0.5, 0.5, 5.0, 5.0], [0.5, 0.5, -5.0, -5.0],
                       [0.5, 0.5, 5.0, 0.0], [1e30, 1e30, 0.0, 0.0]],
                      device=cuda)
    assert torch.equal(st_kernel.st_gather_cuda(img, zw, (8, 8)),
                       torch.zeros((4, 8, 8), device=cuda))


def test_near_zero_scale_paste_is_finite_and_zero(cuda):
    g = torch.rand((2, 20, 20), device=cuda)
    zw = torch.tensor([[0.0, 0.0, 0.01, 0.01], [1e-9, -1e-9, 0.0, 0.0]],
                      device=cuda)
    out = tst.st_paste(g, zw, (50, 50))
    assert bool(torch.isfinite(out).all()) and out.abs().max().item() == 0.0


def test_nan_coordinates_give_nan_where_plain_does(cuda):
    img, zw = inputs(3, (30, 30), 4)
    zw[1, 0] = float("nan")                     # one column coordinate
    zw[2, 3] = float("nan")                     # one row coordinate
    out = st_kernel.st_gather_cuda(img, zw, (6, 6))
    ref = st_kernel.st_gather_plain(img, zw, (6, 6))
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.isnan(out[1:]).all() and not torch.isnan(out[0]).any()


def test_dispatch_and_launch_count(cuda):
    img, zw = inputs(6, (50, 50), 5)
    before = st_kernel.launches
    out = tst.st_gather(img.reshape(2, 3, 50, 50), zw.reshape(2, 3, 4),
                        (20, 20))
    assert out.shape == (2, 3, 20, 20) and st_kernel.launches == before + 1
    tst.st_paste(out, zw.reshape(2, 3, 4), (50, 50))
    assert st_kernel.launches == before + 2
    st_kernel.st_gather_plain(img, zw, (20, 20))
    assert st_kernel.launches == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img, zw = inputs(4, (10, 10), 6)
    with pytest.raises(TypeError):
        st_kernel.st_gather_cuda(img.double(), zw, (5, 5))
    with pytest.raises(ValueError, match="contiguous"):
        st_kernel.st_gather_cuda(img.transpose(1, 2), zw, (5, 5))
    with pytest.raises(ValueError, match="one device"):
        st_kernel.st_gather_cuda(img, zw.cpu(), (5, 5))
    with pytest.raises(ValueError, match="zw"):
        st_kernel.st_gather_cuda(img, zw[:3], (5, 5))
    g = torch.ones((4, 5, 5), device=cuda)
    with pytest.raises(ValueError, match="want g"):
        st_kernel.st_gather_bwd_cuda(img, zw, g[:, :4].contiguous(), (5, 5))
    with pytest.raises(TypeError):
        st_kernel.st_gather_bwd_cuda(img, zw, g.double(), (5, 5))
    with pytest.raises(ValueError, match="one device"):
        st_kernel.st_gather_bwd_cuda(img, zw, g.cpu(), (5, 5))
    with pytest.raises(RuntimeError, match="CUDA error"):    # shared memory
        st_kernel.st_gather_bwd_cuda(
            torch.zeros((1, 300, 300), device=cuda), zw[:1],
            torch.zeros((1, 200, 200), device=cuda), (200, 200))
    # gradients are no longer refused: autograd reaches the backward kernel
    before = st_kernel.bwd_launches
    tst.st_gather(img, zw.requires_grad_(), (5, 5)).sum().backward()
    assert zw.grad.shape == (4, 4) and st_kernel.bwd_launches == before + 1


def test_model_on_the_card_matches_the_cpu(cuda):
    """A small model through the kernel on the card against the same
    weights and noise through the plain version on the CPU."""
    from attend_infer_repeat_torch import configs
    from attend_infer_repeat_torch.models.air import AIRModel
    from attend_infer_repeat_torch.serving import make_infer_fn

    model_cfg = configs.ModelConfig(img_size=(24, 24), glimpse_size=(10, 10),
                                    n_what=8, rnn_hidden=32)
    cfg = dataclasses.replace(configs.get_config("serving"), model=model_cfg)
    cpu = AIRModel(model_cfg, use_baseline=False, device="cpu", seed=3)
    card = AIRModel(model_cfg, use_baseline=False, device=cuda, seed=3)
    x = torch.rand((16, 24, 24), generator=torch.Generator().manual_seed(0))
    noise = cpu.sample_noise(16, torch.Generator().manual_seed(1))
    ref = make_infer_fn(cfg, cpu)(x, noise=noise)
    infer = make_infer_fn(cfg, card)
    noise = tuple(a.to(cuda) for a in noise)
    before = st_kernel.launches
    out = infer(x.to(cuda), noise=noise)
    # the graph's first call: its warm-up runs, then one replay
    per_call = 2 * model_cfg.max_steps
    assert st_kernel.launches == before + (graphs.WARMUP + 1) * per_call
    assert torch.equal(infer(x.to(cuda), noise=noise)["canvas"],
                       out["canvas"])
    assert st_kernel.launches == before + (graphs.WARMUP + 2) * per_call
    assert torch.equal(out["presence"].cpu(), ref["presence"])
    for k in ("canvas", "z_where", "what_loc", "num_steps_pmf"):
        assert max_err(out[k].cpu(), ref[k]) <= 1e-4, k
    torch.testing.assert_close(out["elbo"].cpu(), ref["elbo"], rtol=1e-5,
                               atol=1e-3)


BWD_CASES = [  # n, input, output, paste
    (1, (50, 50), (20, 20), False),
    (5, (50, 50), (20, 20), False),
    (1023, (50, 50), (20, 20), False),
    (1024, (50, 50), (20, 20), False),
    (17, (20, 20), (50, 50), True),
    (1024, (20, 20), (50, 50), True),
    (7, (25, 31), (9, 13), False),
    (3, (1, 40), (1, 7), False),
]


def bwd_close(kernel, plain, rel):
    torch.cuda.synchronize()
    scale = max(1.0, plain.abs().max().item())
    return (kernel - plain).abs().max().item() <= rel * scale


@pytest.mark.parametrize("mode", sorted(TOL))
@pytest.mark.parametrize("n, in_shape, out_shape, paste", BWD_CASES)
def test_backward_kernel_matches_plain(cuda, mode, n, in_shape, out_shape,
                                       paste):
    img, zw = inputs(n, in_shape, n, paste)
    g = torch.randn((n,) + out_shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(n))
    k_img, k_zw = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode)
    p_img, p_zw = st_kernel.st_gather_bwd_plain(img, zw, g, out_shape, mode)
    assert k_img.shape == img.shape and k_zw.shape == (n, 4)
    assert bwd_close(k_img, p_img, 1e-5)
    assert bwd_close(k_zw, p_zw, 1e-4)
    none, z_only = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode,
                                                need_img=False)
    assert none is None and torch.equal(z_only, k_zw)


def test_backward_out_of_range_is_exactly_zero(cuda):
    img = torch.rand((4, 20, 20), device=cuda)
    zw = torch.tensor([[0.5, 0.5, 5.0, 5.0], [0.5, 0.5, -5.0, -5.0],
                       [0.5, 0.5, 5.0, 0.0], [1e30, 1e30, 0.0, 0.0]],
                      device=cuda)
    g_img, g_zw = st_kernel.st_gather_bwd_cuda(
        img, zw, torch.randn((4, 8, 8), device=cuda), (8, 8))
    assert g_img.abs().max().item() == 0 and g_zw.abs().max().item() == 0
    # near-zero scales through invert_where: |p| ~ 1e7, a paste of nothing
    inv = tst.invert_where(torch.tensor(
        [[0.0, 0.0, 0.01, 0.01], [1e-9, -1e-9, 0.0, 0.0]], device=cuda))
    g_img, g_zw = st_kernel.st_gather_bwd_cuda(
        torch.rand((2, 20, 20), device=cuda), inv.contiguous(),
        torch.randn((2, 50, 50), device=cuda), (50, 50))
    assert g_img.abs().max().item() == 0 and g_zw.abs().max().item() == 0


def test_backward_nan_where_plain_gives_nan(cuda):
    img, zw = inputs(3, (30, 30), 4)
    zw[1, 0] = float("nan")                     # column coordinates
    zw[2, 3] = float("nan")                     # row coordinates
    g = torch.randn((3, 6, 6), device=cuda)
    k = st_kernel.st_gather_bwd_cuda(img, zw, g, (6, 6))
    p = st_kernel.st_gather_bwd_plain(img, zw, g, (6, 6))
    for a, b in zip(k, p):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert not torch.isnan(k[0][0]).any() and torch.isnan(k[0][1:]).all()


def test_backward_kernel_is_deterministic(cuda):
    img, zw = inputs(512, (20, 20), 8, paste=True)
    g = torch.randn((512, 50, 50), device=cuda)
    a = st_kernel.st_gather_bwd_cuda(img, zw, g, (50, 50))
    b = st_kernel.st_gather_bwd_cuda(img, zw, g, (50, 50))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """A small model's train step through both kernels on the card against
    the same weights, batch and noise through the plain versions on the
    CPU: 2 forward and 2 backward launches per cell step."""
    import copy

    from attend_infer_repeat_torch import configs
    from attend_infer_repeat_torch.train import (
        create_train_state, make_train_step)
    from attend_infer_repeat_torch.train.step import (
        kl_warmup, make_objective_loss_fn)

    model_cfg = configs.ModelConfig(img_size=(24, 24), glimpse_size=(10, 10),
                                    n_what=8, rnn_hidden=32)
    cfg = dataclasses.replace(configs.get_config("canonical"),
                              model=model_cfg)
    cpu = create_train_state(cfg, seed=3, device="cpu")
    card = copy.deepcopy(cpu)
    card.model.to(cuda)
    card.opt_state = {k: dataclasses.replace(
        v, nu=[t.to(cuda) for t in v.nu], trace=[t.to(cuda) for t in v.trace])
        for k, v in card.opt_state.items()}
    x = torch.rand((16, 24, 24), generator=torch.Generator().manual_seed(0))
    nums = torch.zeros(16, dtype=torch.int32)
    noise = cpu.model.sample_noise(16, torch.Generator().manual_seed(1))
    noise_card = tuple(a.to(cuda) for a in noise)
    p = torch.tensor(0.5)

    def grads(state, imgs, nz):
        loss, _ = make_objective_loss_fn(cfg, state.model, imgs, None, p,
                                         kl_warmup(cfg, 0), nz)()
        names, params = zip(*state.model.named_parameters())
        # detached: a live autograd graph keeps the parameters' gradient
        # nodes on this stream, which the step's capture may not join
        return loss.detach(), dict(zip(names,
                                       torch.autograd.grad(loss, params)))

    loss_c, g_c = grads(cpu, x, noise)
    before = (st_kernel.launches, st_kernel.bwd_launches)
    loss_k, g_k = grads(card, x.to(cuda), noise_card)
    t = model_cfg.max_steps
    assert (st_kernel.launches, st_kernel.bwd_launches) == (
        before[0] + 2 * t, before[1] + 2 * t)
    torch.testing.assert_close(loss_k.cpu(), loss_c, rtol=1e-5, atol=0)
    for n, g in g_c.items():
        err = ((g_k[n].cpu() - g).norm() / g.norm().clamp(min=1e-30)).item()
        assert err <= 1e-4, (n, err)
    step_c = make_train_step(cfg, cpu.model)
    step_k = make_train_step(cfg, card.model)
    _, m_c = step_c(cpu, (x, nums), noise=noise)
    _, m_k = step_k(card, (x.to(cuda), nums.to(cuda)), noise=noise_card)
    for k, v in m_c.items():
        torch.testing.assert_close(m_k[k].cpu(), v, rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def branch_where(kind, n, in_shape, out_shape, paste, seed):
    """``chip_smoke.branch_where``: windows that reach one kernel branch
    (``chip_smoke.WINDOW_CASES`` names it)."""
    assert kind in chip_smoke().WINDOW_CASES
    gen = torch.Generator("cuda").manual_seed(seed)
    return chip_smoke().branch_where(kind, n, in_shape, out_shape, paste,
                                     gen, tst.invert_where)


WINDOW_KINDS = ["step-like windows", "one live row and column",
                "windows on each edge", "negative scales", "dead beside live",
                "tiny scales at an edge"]
BRANCH_SHAPES = [  # input, output, paste
    ((50, 50), (20, 20), False),
    ((20, 20), (50, 50), True),
    ((25, 31), (9, 13), False),
]


@pytest.mark.parametrize("mode", sorted(TOL))
@pytest.mark.parametrize("in_shape, out_shape, paste", BRANCH_SHAPES)
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_kernels_match_plain_on_branch_windows(cuda, mode, kind, in_shape,
                                               out_shape, paste):
    """Both kernels against plain on windows that reach each branch (live
    intervals, zero rows, edge taps, decreasing p, dead examples), at a
    ragged N; the backward twice, bit-identical."""
    n = 257
    img, _ = inputs(n, in_shape, 11)
    zw = branch_where(kind, n, in_shape, out_shape, paste, 12)
    out = st_kernel.st_gather_cuda(img, zw, out_shape, mode)
    assert max_err(out, st_kernel.st_gather_plain(img, zw, out_shape,
                                                  mode)) <= TOL[mode]
    g = torch.randn((n,) + out_shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(13))
    k_img, k_zw = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode)
    p_img, p_zw = st_kernel.st_gather_bwd_plain(img, zw, g, out_shape, mode)
    assert bwd_close(k_img, p_img, 1e-5)
    assert bwd_close(k_zw, p_zw, 1e-4)
    again = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode)
    assert torch.equal(again[0], k_img) and torch.equal(again[1], k_zw)
    none, z_only = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode,
                                                need_img=False)
    assert none is None and torch.equal(z_only, k_zw)


@pytest.mark.parametrize("in_shape, out_shape, window, live_px, dead_px", [
    # a paste (the live-rectangle design): the glimpse spans a quarter of
    # the canvas, at its centre
    ((20, 20), (50, 50), [4.0, 4.0, 0.0, 0.0], (25, 25), (0, 0)),
    # a gather (the dense design): the window's right part leaves the image
    ((50, 50), (20, 20), [0.5, 0.5, 0.9, 0.0], (10, 0), (10, 19)),
])
def test_backward_nan_cotangent_contract(cuda, in_shape, out_shape, window,
                                         live_px, dead_px):
    """A NaN or an infinity in the cotangent gives both gradients the
    dense plain version's pattern of NaN and +-inf, at a pixel with a live
    tap and at one with none (where the dense form spreads it: 0 * NaN,
    0 * inf); a finite example beside them keeps its bits."""
    img, _ = inputs(3, in_shape, 14)
    zw = torch.tensor([window] * 3, device=cuda)
    for value in (float("nan"), float("inf"), -float("inf")):
        g = torch.randn((3,) + out_shape, device=cuda)
        g[(0,) + live_px] = value
        g[(1,) + dead_px] = value
        k = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape)
        p = st_kernel.st_gather_bwd_plain(img, zw, g, out_shape)
        for a, b in zip(k, p):
            assert_same_pattern(a[:2], b[:2])
            assert not torch.isfinite(b[:2]).all()
        ref = st_kernel.st_gather_bwd_cuda(img[2:], zw[2:], g[2:], out_shape)
        assert torch.equal(k[0][2:], ref[0]) and torch.equal(k[1][2:], ref[1])


def assert_same_pattern(kernel, plain, tol=1e-5):
    """NaN, +inf and -inf where the plain version has them, and the
    finite entries within ``tol`` of max(1, max|plain|) of the plain's."""
    torch.cuda.synchronize()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(kernel), test(plain)), test.__name__
    finite = torch.isfinite(plain)
    if finite.any():
        scale = max(1.0, plain[finite].abs().max().item())
        err = (kernel[finite] - plain[finite]).abs().max().item()
        assert err <= tol * scale, err


def tapped_pixels(zw, in_shape, out_shape):
    """``(live, dead)``: an input pixel of example 0 that some output taps
    with a nonzero weight, and one that none does."""
    w_y, w_x = tst.st_weights(zw[:1], out_shape, in_shape)
    live = (w_y[0] != 0).any(0)[:, None] & (w_x[0] != 0).any(0)[None, :]
    return (tuple(live.nonzero()[len(live.nonzero()) // 2].tolist()),
            tuple((~live).nonzero()[0].tolist()))


NONFINITE_SHAPES = [  # input, output, window (sx, sy, tx, ty), paste?
    ((50, 50), (20, 20), [0.3, 0.3, 0.2, 0.2], False),
    ((20, 20), (50, 50), [0.5, 0.5, 0.9, 0.0], True),
]
NONFINITE_VALUES = [float("nan"), float("inf"), -float("inf")]


def nonfinite_inputs(cuda, in_shape, out_shape, window, paste, value, live):
    """Three examples on one window: example 0 holds ``value`` at a live
    (or dead) input pixel, example 1 at the other kind, example 2 none."""
    img, _ = inputs(3, in_shape, 15)
    zw = torch.tensor([window] * 3, device=cuda)
    if paste:
        zw = tst.invert_where(zw).contiguous()
    live_px, dead_px = tapped_pixels(zw, in_shape, out_shape)
    img[(0,) + (live_px if live else dead_px)] = value
    img[(1,) + (dead_px if live else live_px)] = value
    return img, zw


@pytest.mark.parametrize("mode", sorted(TOL))
@pytest.mark.parametrize("live", [True, False], ids=["live", "dead"])
@pytest.mark.parametrize("value", NONFINITE_VALUES, ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("in_shape, out_shape, window, paste",
                         NONFINITE_SHAPES, ids=["gather", "paste"])
def test_forward_nonfinite_pixels_match_plain(cuda, in_shape, out_shape,
                                              window, paste, value, live,
                                              mode):
    """A NaN or an infinity in the image gives the gather the plain
    (dense) version's pattern of NaN and +-inf, at a pixel some output
    taps and at one none does; the finite example keeps its bits."""
    img, zw = nonfinite_inputs(cuda, in_shape, out_shape, window, paste,
                               value, live)
    out = st_kernel.st_gather_cuda(img, zw, out_shape, mode)
    ref = st_kernel.st_gather_plain(img, zw, out_shape, mode)
    assert_same_pattern(out[:2], ref[:2], TOL[mode])
    assert not torch.isfinite(ref[:2]).all(1).all(1).any()
    alone = st_kernel.st_gather_cuda(img[2:], zw[2:], out_shape, mode)
    assert torch.equal(out[2:], alone)


def test_forward_infinity_reaches_its_taps_only_as_infinity(cuda):
    """One inf at a tapped pixel of a 50x50 -> 20x20 gather: inf at the
    outputs that tap it, NaN at every other one, as the dense form."""
    img, zw = nonfinite_inputs(cuda, (50, 50), (20, 20),
                               [0.3, 0.3, 0.2, 0.2], False, float("inf"),
                               True)
    out = st_kernel.st_gather_cuda(img[:1], zw[:1], (20, 20))
    ref = st_kernel.st_gather_plain(img[:1], zw[:1], (20, 20))
    assert_same_pattern(out, ref)
    n_inf = int(torch.isposinf(out).sum())
    assert 1 <= n_inf <= 9 and int(torch.isnan(out).sum()) == 400 - n_inf


@pytest.mark.parametrize("mode", sorted(TOL))
@pytest.mark.parametrize("live", [True, False], ids=["live", "dead"])
@pytest.mark.parametrize("value", NONFINITE_VALUES, ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("in_shape, out_shape, window, paste",
                         NONFINITE_SHAPES, ids=["gather", "paste"])
def test_backward_nonfinite_image_matches_plain(cuda, in_shape, out_shape,
                                                window, paste, value, live,
                                                mode):
    """A NaN or an infinity in the image gives g_zw the plain version's
    pattern (g_img does not read the image: it stays finite), with and
    without g_img; the finite example keeps its bits."""
    img, zw = nonfinite_inputs(cuda, in_shape, out_shape, window, paste,
                               value, live)
    g = torch.randn((3,) + out_shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(16))
    k = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode)
    p = st_kernel.st_gather_bwd_plain(img, zw, g, out_shape, mode)
    assert_same_pattern(k[0], p[0])
    assert_same_pattern(k[1], p[1], 1e-4)
    assert not torch.isfinite(p[1][:2]).all()
    none, z_only = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode,
                                                need_img=False)
    assert none is None and torch.equal(
        torch.isnan(z_only), torch.isnan(k[1]))
    alone = st_kernel.st_gather_bwd_cuda(img[2:], zw[2:], g[2:], out_shape,
                                         mode)
    assert torch.equal(k[0][2:], alone[0]) and torch.equal(k[1][2:], alone[1])


# --- the fused paste: paste, presence mask, f32 add and carry cast -----------

CARRIES = {"f32": torch.float32, "bf16": torch.bfloat16}


# What the fused kernel replaces, on the card: the paste kernel, the
# presence mask, the f32 add and the cast back to the carry.
unfused_update = functools.partial(st_kernel.st_gather_accumulate_plain,
                                   paste=st_kernel.STGather.apply)


def assert_bits(got, want):
    """Equal bit for bit, with NaN at the same entries (whatever their
    payload)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    assert torch.equal(got.view(ints[got.dtype])[~nan],
                       want.view(ints[want.dtype])[~nan])


def update_inputs(n, canvas_shape, carry, seed, glimpse=None, zw=None):
    """A carried canvas (with -0 in it), 20x20 glimpses, windows partly
    off the canvas and every fifth wholly off, presence 0 and 1."""
    gen = torch.Generator("cuda").manual_seed(seed)
    canvas = torch.randn((n,) + tuple(canvas_shape), generator=gen,
                         device="cuda").to(carry)
    canvas[0, 0, :4] = -0.0
    if glimpse is None:
        glimpse = torch.rand((n, 20, 20), generator=gen, device="cuda")
    if zw is None:
        where = torch.cat([0.2 + torch.rand((n, 2), generator=gen,
                                            device="cuda"),
                           1.6 * torch.rand((n, 2), generator=gen,
                                            device="cuda") - 0.8], 1)
        where[::5, 2] = 5.0
        zw = tst.invert_where(where).contiguous()
    z_pres = (torch.rand(n, generator=gen, device="cuda") < 0.6).float()
    z_pres[:2] = torch.tensor([0.0, 1.0])
    return canvas, glimpse, zw, z_pres


def check_fused(canvas, glimpse, zw, z_pres, seed=0):
    """The fused kernel against the unfused ops, bit for bit: the canvas,
    and the canvas's, the glimpse's and the window's gradients."""
    out = st_kernel.st_gather_accumulate_cuda(canvas, glimpse, zw, z_pres)
    assert_bits(out, unfused_update(canvas, glimpse, zw, z_pres))
    g = torch.randn(canvas.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    g = g.to(canvas.dtype)
    grads = []
    for fn in (st_kernel.STGatherAccumulate.apply, unfused_update):
        leaves = [t.clone().requires_grad_() for t in (canvas, glimpse, zw)]
        fn(*leaves, z_pres).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert_bits(got, want)
    return out


@pytest.mark.parametrize("carry", sorted(CARRIES))
@pytest.mark.parametrize("n, canvas_shape", [
    (1024, (50, 50)), (8192, (50, 50)), (1024, (100, 100)), (17, (50, 50)),
    (5, (9, 13)),
])
def test_fused_paste_is_the_unfused_chain(cuda, carry, n, canvas_shape):
    """At the cells' shapes (50x50 <- 20x20 at the train and serve batch,
    crowded's 100x100), a ragged N and an odd canvas (one pixel a run)."""
    canvas, glimpse, zw, z_pres = update_inputs(n, canvas_shape,
                                                CARRIES[carry], n)
    out = check_fused(canvas, glimpse, zw, z_pres, n)
    # presence 0 leaves the canvas as it was (an exact f32 round trip)
    assert torch.equal(out[0], canvas[0])
    assert not torch.equal(out[1], canvas[1])


@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_fused_paste_on_a_misaligned_canvas(cuda, carry):
    """A canvas that starts one element into its buffer takes the one
    pixel a run path, with the same bits."""
    canvas, glimpse, zw, z_pres = update_inputs(33, (50, 50), CARRIES[carry],
                                                3)
    buf = torch.empty(canvas.numel() + 1, dtype=canvas.dtype, device="cuda")
    shifted = buf[1:].view(canvas.shape)
    shifted.copy_(canvas)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8
    check_fused(shifted, glimpse, zw, z_pres)


@pytest.mark.parametrize("carry", sorted(CARRIES))
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_fused_paste_on_branch_windows(cuda, carry, kind):
    """The windows that reach each branch of the gather, as pastes."""
    n = 257
    zw = branch_where(kind, n, (20, 20), (50, 50), True, 21)
    canvas, glimpse, zw, z_pres = update_inputs(n, (50, 50), CARRIES[carry],
                                                22, zw=zw)
    check_fused(canvas, glimpse, zw, z_pres)


@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_fused_paste_nan_windows(cuda, carry):
    """A NaN row or column coordinate: NaN where the unfused ops have it,
    with presence 0 too (0 * NaN)."""
    canvas, glimpse, zw, z_pres = update_inputs(4, (50, 50), CARRIES[carry],
                                                23)
    zw[1, 0] = float("nan")
    zw[2, 3] = float("nan")
    z_pres[:] = torch.tensor([1.0, 1.0, 0.0, 1.0])
    out = check_fused(canvas, glimpse, zw, z_pres)
    assert torch.isnan(out[1:3]).any(1).any(1).all()


@pytest.mark.parametrize("carry", sorted(CARRIES))
@pytest.mark.parametrize("live", [True, False], ids=["live", "dead"])
@pytest.mark.parametrize("value", NONFINITE_VALUES, ids=["nan", "inf", "-inf"])
def test_fused_paste_nonfinite_glimpse(cuda, value, live, carry):
    """``nonfinite_inputs``' glimpses (a NaN or an infinity at a tapped
    and at an untapped pixel): the dense fallback's pattern, with the
    update, bit for bit; presence 0 on one of them."""
    img, zw = nonfinite_inputs(cuda, (20, 20), (50, 50),
                               NONFINITE_SHAPES[1][2], True, value, live)
    canvas, glimpse, zw, z_pres = update_inputs(3, (50, 50), CARRIES[carry],
                                                24, glimpse=img, zw=zw)
    z_pres[:] = torch.tensor([1.0, 0.0, 1.0])
    out = check_fused(canvas, glimpse, zw, z_pres)
    assert not torch.isfinite(out[:2]).all()


def test_fused_paste_counts_and_refuses(cuda):
    """A launch counts in ``launches`` and under its shape; the wrapper
    refuses a canvas that is not contiguous or not f32/bf16, and shapes
    that do not match."""
    canvas, glimpse, zw, z_pres = update_inputs(6, (50, 50), torch.bfloat16,
                                                25)
    before = st_kernel.launches
    key = ("st_gather_accumulate", 6, 20, 20, 50, 50)
    shaped = st_kernel.shape_launches[key]
    out = tst.st_paste_accumulate(canvas.reshape(2, 3, 50, 50),
                                  glimpse.reshape(2, 3, 20, 20),
                                  tst.invert_where(zw).reshape(2, 3, 4),
                                  z_pres.reshape(2, 3, 1))
    assert out.shape == (2, 3, 50, 50) and out.dtype == torch.bfloat16
    assert st_kernel.launches == before + 1
    assert st_kernel.shape_launches[key] == shaped + 1
    fn = st_kernel.st_gather_accumulate_cuda
    with pytest.raises(ValueError, match="contiguous"):
        fn(canvas.transpose(1, 2), glimpse, zw, z_pres)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="canvas"):
            fn(canvas.to(dtype), glimpse, zw, z_pres)
    with pytest.raises(TypeError):
        fn(canvas, glimpse.double(), zw, z_pres)
    with pytest.raises(ValueError, match="z_pres"):
        fn(canvas, glimpse, zw, z_pres[:5].contiguous())
    with pytest.raises(ValueError, match="one device"):
        fn(canvas.cpu(), glimpse, zw, z_pres)
    assert st_kernel.launches == before + 1
