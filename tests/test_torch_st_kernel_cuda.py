"""PyTorch port: the hand-written gather kernel on the card, against its
plain PyTorch version on the same inputs.

Needs a CUDA card and ``nvcc``; every test skips without a card.  The
kernel has no CPU mode, so these run only on the card, without the JAX
package's conftest (the card's machine has no JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_st_kernel_cuda.py

Limits: max abs error 1e-5 in f32 and 2e-2 in bf16 mode, the JAX
package's limits for its Pallas kernel against the einsum path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from attend_infer_repeat_torch.ops import spatial_transformer as tst
from attend_infer_repeat_torch.ops import st_kernel

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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
    with pytest.raises(NotImplementedError, match="backward"):
        st_kernel.st_gather_cuda(img, zw.requires_grad_(), (5, 5))


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
    before = st_kernel.launches
    out = make_infer_fn(cfg, card)(x.to(cuda),
                                   noise=tuple(a.to(cuda) for a in noise))
    assert st_kernel.launches == before + 2 * model_cfg.max_steps
    assert torch.equal(out["presence"].cpu(), ref["presence"])
    for k in ("canvas", "z_where", "what_loc", "num_steps_pmf"):
        assert max_err(out[k].cpu(), ref[k]) <= 1e-4, k
    torch.testing.assert_close(out["elbo"].cpu(), ref["elbo"], rtol=1e-5,
                               atol=1e-3)
