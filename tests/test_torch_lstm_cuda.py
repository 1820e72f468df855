"""PyTorch port: the LSTM cell's pointwise kernels (``csrc/lstm_cell.cu``)
on the card, against the unfused ops they replace.

- The forward kernel gives ``c`` and ``h``, and the backward kernel the
  gates' gradient and ``c_prev``'s, bit for bit as the unfused ops and
  autograd of them give them: at 1,024, 5,120 and 8,192 rows of 256
  hidden units (16-byte loads), at a width of 30 (one unit a thread),
  with either cotangent absent, with NaN and ±inf in the inputs, and with
  ``c_prev`` and the cotangents as row-strided views (a slot of a
  ``(B, N, H)`` state, a part of a concatenation's gradient), aligned and
  not.
- PyTorch's ``tanh_backward`` rounds ``1 - y * y`` once (a fused
  multiply-add), as the kernel does.
- ``LSTMCell`` on the card always takes the kernels, over the rows of
  every leading dimension, and raises on a dtype other than float32;
  ``lstm_counts`` counts the launches of an eager step: 240 forward and
  120 backward in a SQAIR step (120 uses, each forward twice under remat
  ``save_st``), 6 and 3 in a ``canonical_fast`` step.

Needs a CUDA card and ``nvcc``; every test skips without a card.  Run on
the card without the JAX package's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_lstm_cuda.py
"""

import pytest
import torch

from attend_infer_repeat_torch.models import modules
from attend_infer_repeat_torch.ops import lstm_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LSTM kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(gen, *shape, scale=3.0):
    return scale * torch.randn(shape, generator=gen, device="cuda")


def inputs(rows, hidden, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (randn(gen, rows, 4 * hidden), randn(gen, rows, 4 * hidden),
            randn(gen, rows, hidden), randn(gen, rows, hidden),
            randn(gen, rows, hidden))


def want(a, b, c_prev, dh, dc):
    """The unfused ops' ``c``, ``h`` (``lstm_cell_plain``, which the CPU
    tests hold to ``LSTMCell``'s ops) and autograd's gradients of a, b and
    c_prev for the cotangents given (None: absent)."""
    a, b, c_prev = (t.detach().requires_grad_() for t in (a, b, c_prev))
    c, h = lstm_kernel.lstm_cell_plain(a, b, c_prev)
    outs, cots = zip(*[(t, g) for t, g in ((c, dc), (h, dh))
                       if g is not None])
    return (c.detach(), h.detach(),
            *torch.autograd.grad(outs, (a, b, c_prev), cots))


def got(a, b, c_prev, dh, dc):
    c, h = lstm_kernel.lstm_cell_cuda(a, b, c_prev)
    d_gates, dc_prev = lstm_kernel.lstm_cell_bwd_cuda(a, b, c_prev, dh, dc)
    return c, h, d_gates, d_gates, dc_prev


def assert_same(got_, want_):
    torch.cuda.synchronize()
    for name, g, w in zip(("c", "h", "d_a", "d_b", "dc_prev"), got_, want_):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


@pytest.mark.parametrize("rows, hidden", [(1024, 256), (5120, 256),
                                          (8192, 256), (1000, 30)])
@pytest.mark.parametrize("cots", ["both", "no-dh", "no-dc"])
def test_kernels_equal_unfused_ops(cuda, rows, hidden, cots):
    a, b, c_prev, dh, dc = inputs(rows, hidden, rows + hidden)
    dh = None if cots == "no-dh" else dh
    dc = None if cots == "no-dc" else dc
    assert_same(got(a, b, c_prev, dh, dc), want(a, b, c_prev, dh, dc))
    _, none = lstm_kernel.lstm_cell_bwd_cuda(a, b, c_prev, dh, dc,
                                             need_c_prev=False)
    assert none is None


@pytest.mark.parametrize("hidden", [256, 30])
def test_non_finite_inputs_propagate_as_unfused(cuda, hidden):
    a, b, c_prev, dh, dc = inputs(64, hidden, 3)
    nan, inf = float("nan"), float("inf")
    a[0, 0], a[1, hidden + 2], a[2, 3 * hidden + 1] = nan, inf, -inf
    b[3, 2 * hidden + 1], b[4, 3 * hidden + 4], b[5, 5] = -inf, inf, nan
    b[6, hidden] = inf
    a[6, hidden] = -inf                         # inf - inf in the gate add
    c_prev[7, 5], c_prev[8, 0], c_prev[9, 1] = inf, nan, -inf
    dh[10, 3], dc[11, 2] = nan, inf
    w = want(a, b, c_prev, dh, dc)
    assert not all(torch.isfinite(t).all() for t in w)
    assert_same(got(a, b, c_prev, dh, dc), w)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_strided_state_and_cotangents(cuda, offset):
    """``c_prev`` a slot of a ``(B, N, H)`` state and the cotangents parts
    of a wider gradient, as SQAIR and the concatenations after the cell
    give them: read in place (16-byte loads where aligned, one unit a
    thread where an offset breaks the alignment), same bits."""
    rows, hidden, slots = 5120, 256, 3
    a, b, *_ = inputs(rows, hidden, 17)
    gen = torch.Generator(device="cuda").manual_seed(18)
    state = randn(gen, rows, slots, hidden + offset)
    wide = randn(gen, rows, 2 * hidden + offset)
    c_prev = state[:, 1, offset:]
    dh, dc = wide[:, offset:offset + hidden], wide[:, offset + hidden:]
    assert c_prev.stride() == (slots * (hidden + offset), 1)
    assert not dh.is_contiguous() and dh.stride(1) == 1
    assert_same(got(a, b, c_prev, dh, dc), want(a, b, c_prev, dh, dc))


def test_tanh_backward_rounds_one_minus_square_once(cuda):
    """PyTorch's CUDA ``tanh_backward(g, y)`` is ``g * fma(-y, y, 1)``: its
    binary contracts ``1 - y * y``.  The kernel pins that form; the other
    (``1 - y * y`` rounded twice) differs on these inputs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.tanh(randn(gen, 1 << 20))
    g = randn(gen, 1 << 20)
    aten = torch.ops.aten.tanh_backward(g, y)
    once = g * (1.0 - y.double() * y.double()).float()
    twice = g * (1.0 - y * y)
    assert torch.equal(aten, once)
    assert not torch.equal(aten, twice)


def test_leading_dims_take_the_kernels_and_other_dtypes_raise(cuda):
    """``LSTMCell`` on the card always launches the kernels: a 3-D input
    and state run as rows (counted ``fused`` and ``fused_bwd``) and give
    the unfused ops' bits in their own shape; float64 and bf16 raise,
    since the cell runs in float32; CPU tensors launch nothing."""
    torch.manual_seed(0)
    cell = modules.LSTMCell(5, 8).cuda()
    x, c, h = (torch.randn(2, 6, n, device="cuda") for n in (5, 8, 8))
    before = modules.lstm_counts.copy()
    (c2, h2), _ = cell((c, h), x)
    (c2.sum() + h2.sum()).backward()
    assert modules.lstm_counts - before == {"fused": 1, "fused_bwd": 1}
    assert h2.shape == (2, 6, 8)
    want = lstm_kernel.lstm_cell_plain(cell.ih(x), cell.hh(h), c)
    assert_same((c2, h2), want)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="float32"):
            cell.to(dtype)((c.to(dtype), h.to(dtype)), x.to(dtype))
    cpu = modules.LSTMCell(5, 8)
    before = modules.lstm_counts.copy()
    cpu((c.cpu(), h.cpu()), x.cpu())
    assert modules.lstm_counts == before


def step_counts(scan, state, steps):
    """``lstm_counts`` over one eager call of ``scan`` a step."""
    from attend_infer_repeat_torch.utils import debug_mode

    before = modules.lstm_counts.copy()
    with debug_mode(nans=False):
        scan(state)
    torch.cuda.synchronize()
    counts = modules.lstm_counts - before
    return {k: v / steps for k, v in counts.items()}


def test_lstm_counts_of_a_sqair_step(cuda):
    """120 LSTM uses a step (temporal, relation and prior a slot and
    frame, discovery's a step and frame), each forward twice."""
    from air_bench import program
    from test_torch_sqair_cuda import setup as sqair_setup

    cfg, bank, state = sqair_setup(cuda, 5)
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, 2)
    assert step_counts(scan, state, 2) == {"fused": 240, "fused_bwd": 120}


def test_lstm_counts_of_a_canonical_fast_step(cuda):
    from attend_infer_repeat_torch import configs as tcfg
    from attend_infer_repeat_torch.data import load_digit_bank
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step)

    cfg = tcfg.get_config("canonical_fast")
    bank = load_digit_bank("auto", digit_size=cfg.data.digit_size)[0]
    state = create_train_state(cfg, seed=3)
    scan = make_scan_train_step(cfg, state.model, bank, 2)
    assert step_counts(scan, state, 2) == {"fused": 6, "fused_bwd": 3}
