"""PyTorch port: the LSTM cell's pointwise chain as one autograd Function
(``models.modules._LSTMPointwise``), on the CPU.

On the card the Function launches ``csrc/lstm_cell.cu``'s two kernels;
here it runs their plain twins (``ops/lstm_kernel.py``), which are the
kernels' yardsticks.  These tests hold the twins, and the Function's
autograd glue around them, bit for bit to autograd of the unfused ops that
``LSTMCell`` runs: ``c``, ``h`` and the gradients of ``a = ih(x)``,
``b = hh(h)`` and ``c_prev``, with either cotangent absent and with a
row-strided ``c_prev`` (a slot of a ``(B, N, H)`` state, as SQAIR passes
it).  ``LSTMCell`` runs the Function on the CPU as on the card, over the
rows of every leading dimension, and launches nothing here.
``tests/test_torch_lstm_cuda.py`` holds the kernels on the card.
"""

import pytest
import torch

from attend_infer_repeat_torch.models import modules
from attend_infer_repeat_torch.ops import lstm_kernel

torch.set_num_threads(1)

ROWS, HIDDEN, SLOTS = 6, 8, 3

# (dh given, dc given, c_prev a strided slot)
CASES = [(True, True, False), (False, True, False), (True, False, False),
         (True, True, True), (False, True, True), (True, False, True)]
IDS = ["both", "no-dh", "no-dc", "both-strided", "no-dh-strided",
       "no-dc-strided"]


def unfused(a, b, c_prev):
    """``LSTMCell.forward``'s unfused ops after its two GEMMs."""
    i, f, g, o = (a + b).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def inputs(seed, strided, scale=3.0):
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return scale * torch.randn(shape, generator=gen)

    a, b = randn(ROWS, 4 * HIDDEN), randn(ROWS, 4 * HIDDEN)
    if strided:
        c_prev = randn(ROWS, SLOTS, HIDDEN)[:, 1]
        assert c_prev.stride() == (SLOTS * HIDDEN, 1)
    else:
        c_prev = randn(ROWS, HIDDEN)
    cot = randn(2, ROWS, HIDDEN)
    return a, b, c_prev, cot[0], cot[1]


def grads(fn, a, b, c_prev, dh, dc):
    """``fn``'s outputs and autograd's gradients of a, b and c_prev."""
    a, b, c_prev = (t.detach().requires_grad_() for t in (a, b, c_prev))
    c, h = fn(a, b, c_prev)
    outs, cots = zip(*[(t, g) for t, g in ((c, dc), (h, dh))
                       if g is not None])
    return (c.detach(), h.detach(),
            *torch.autograd.grad(outs, (a, b, c_prev), cots))


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("has_dh, has_dc, strided", CASES, ids=IDS)
def test_plain_twins_equal_unfused_autograd(has_dh, has_dc, strided):
    """The forward twin gives ``c`` and ``h``, the backward twin the
    gates' gradient (``a``'s and ``b``'s alike) and ``c_prev``'s, as
    autograd of the unfused ops does, bit for bit."""
    a, b, c_prev, dh, dc = inputs(7, strided)
    dh, dc = (dh if has_dh else None), (dc if has_dc else None)
    want = grads(unfused, a, b, c_prev, dh, dc)
    c, h = lstm_kernel.lstm_cell_plain(a, b, c_prev)
    d_gates, dc_prev = lstm_kernel.lstm_cell_bwd_plain(a, b, c_prev, dh, dc)
    assert_same((c, h, d_gates, d_gates, dc_prev), want)
    _, none = lstm_kernel.lstm_cell_bwd_plain(a, b, c_prev, dh, dc,
                                              need_c_prev=False)
    assert none is None


@pytest.mark.parametrize("has_dh, has_dc, strided", CASES, ids=IDS)
def test_function_equals_unfused_autograd(has_dh, has_dc, strided):
    """``_LSTMPointwise`` (the twins on the CPU) under autograd: outputs
    and every gradient as the unfused ops give them, with an absent
    cotangent's term skipped; ``c_prev``'s gradient only when asked."""
    a, b, c_prev, dh, dc = inputs(11, strided)
    dh, dc = (dh if has_dh else None), (dc if has_dc else None)
    assert_same(grads(modules._LSTMPointwise.apply, a, b, c_prev, dh, dc),
                grads(unfused, a, b, c_prev, dh, dc))
    a, b = (t.detach().requires_grad_() for t in (a, b))
    c, h = modules._LSTMPointwise.apply(a, b, c_prev)
    loss = sum(torch.sum(t * g) for t, g in ((c, dc), (h, dh))
               if g is not None)
    loss.backward()
    assert torch.equal(a.grad, b.grad) and c_prev.grad is None


def test_non_finite_inputs_propagate_as_unfused():
    """NaN and ±inf in a, b and c_prev reach the outputs and gradients
    where the unfused ops put them."""
    a, b, c_prev, dh, dc = inputs(3, False)
    a[0, 0], a[1, HIDDEN + 2] = float("nan"), float("inf")
    b[2, 2 * HIDDEN + 1], b[3, 3 * HIDDEN + 4] = float("-inf"), float("inf")
    c_prev[4, 5], c_prev[5, 0] = float("inf"), float("nan")
    want = grads(unfused, a, b, c_prev, dh, dc)
    assert not all(torch.isfinite(t).all() for t in want)
    assert_same(grads(modules._LSTMPointwise.apply, a, b, c_prev, dh, dc),
                want)
    c, h = lstm_kernel.lstm_cell_plain(a, b, c_prev)
    d_gates, dc_prev = lstm_kernel.lstm_cell_bwd_plain(a, b, c_prev, dh, dc)
    assert_same((c, h, d_gates, d_gates, dc_prev), want)


def test_lstm_cell_on_the_cpu_counts_plain():
    """On the CPU ``LSTMCell`` runs ``_LSTMPointwise`` with the plain
    twins: ``lstm_counts`` (the kernels' launches) does not move, and
    ``c``, ``h`` and every gradient are what the unfused ops and their
    autograd give, bit for bit.  The kernels' wrapper refuses CPU
    tensors."""
    torch.manual_seed(0)
    cell = modules.LSTMCell(5, HIDDEN)
    x = torch.randn(ROWS, 5)
    state = (torch.randn(ROWS, HIDDEN), torch.randn(ROWS, HIDDEN))
    before = modules.lstm_counts.copy()
    (c, h), out = cell(state, x)
    (h.sum() + c.sum()).backward()
    assert modules.lstm_counts == before
    assert out is h
    got = (c.detach(), h.detach(),
           *(p.grad.clone() for p in cell.parameters()))
    cell.zero_grad()
    want_c, want_h = unfused(cell.ih(x), cell.hh(state[1]), state[0])
    (want_h.sum() + want_c.sum()).backward()
    assert_same(got, (want_c.detach(), want_h.detach(),
                      *(p.grad for p in cell.parameters())))
    with pytest.raises(ValueError, match="CUDA"):
        lstm_kernel.lstm_cell_cuda(cell.ih(x), cell.hh(state[1]), state[0])


@pytest.mark.parametrize("strided", [False, True], ids=["dense", "slot"])
def test_lstm_cell_over_leading_dims_equals_unfused(strided):
    """A ``(B, N, ...)`` input and state run as ``B * N`` rows and come
    back in their shape: ``c``, ``h`` and the gradients of the input, the
    state and the weights as the unfused ops give them over the same
    dimensions; a state that is a slot of a wider tensor is read as it
    is."""
    torch.manual_seed(1)
    cell = modules.LSTMCell(5, HIDDEN)
    x = torch.randn(2, ROWS, 5, requires_grad=True)
    wide = torch.randn(2, ROWS, SLOTS, HIDDEN, requires_grad=True)
    c0 = wide[:, :, 1] if strided else wide[:, :, 1].detach().clone() \
        .requires_grad_()
    h0 = torch.randn(2, ROWS, HIDDEN, requires_grad=True)
    cot = torch.randn(2, 2, ROWS, HIDDEN)

    def run(fn):
        c, h = fn()
        leaves = (x, c0 if c0.is_leaf else wide, h0, *cell.parameters())
        return (c.detach(), h.detach(), *torch.autograd.grad(
            (c, h), leaves, (cot[0], cot[1])))

    got = run(lambda: cell((c0, h0), x)[0])
    assert got[0].shape == got[1].shape == (2, ROWS, HIDDEN)
    assert_same(got, run(lambda: unfused(cell.ih(x), cell.hh(h0), c0)))
