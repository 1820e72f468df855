"""The LSTM cell's pointwise chain on the card: bindings and plain twins.

``models.modules.LSTMCell`` runs its two GEMMs, ``a = ih(x)`` and
``b = hh(h)`` (each ``(rows, 4H)`` float32, gates i, f, g, o), and then
the chain from the gate add to ``h``.  ``csrc/lstm_cell.cu`` holds that
chain as one kernel each way, built into the spatial-transformer kernels'
library (``st_kernel.build``) and launched on PyTorch's current stream.

``lstm_cell_cuda`` and ``lstm_cell_bwd_cuda`` launch their kernel or
raise: they take CUDA float32 tensors, ``a`` and ``b`` contiguous
``(rows, 4H)`` and ``c_prev`` ``(rows, H)`` with inner stride 1 (any row
stride).
``lstm_cell_plain`` and ``lstm_cell_bwd_plain`` are the same functions as
the unfused PyTorch ops and autograd's formulas for them, in autograd's
order: the kernels' yardsticks (bit for bit) and their CPU stand-ins in
``modules._LSTMPointwise``.
"""

from __future__ import annotations

import torch

from attend_infer_repeat_torch.ops import st_kernel


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           c_prev: torch.Tensor) -> None:
    """Raise unless the kernels take ``(a, b, c_prev)``."""
    if not (a.is_cuda and b.device == a.device and c_prev.device == a.device):
        why = "the kernels take CUDA tensors on one device"
    elif not a.dtype == b.dtype == c_prev.dtype == torch.float32:
        why = (f"the kernels take float32, got {a.dtype}, {b.dtype}, "
               f"{c_prev.dtype}")
    elif a.dim() != 2 or a.shape != b.shape or a.shape[1] % 4:
        why = f"want a and b (rows, 4H), got {tuple(a.shape)}, " \
              f"{tuple(b.shape)}"
    elif not (a.is_contiguous() and b.is_contiguous()):
        why = "a and b must be contiguous"
    elif (c_prev.shape != (a.shape[0], a.shape[1] // 4)
          or c_prev.stride(1) != 1):
        why = f"want c_prev ({a.shape[0]}, {a.shape[1] // 4}) with inner " \
              f"stride 1, got {tuple(c_prev.shape)}, {c_prev.stride()}"
    else:
        return
    raise ValueError(f"{name}: {why}")


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the library's ``name`` with ``args`` and ``device``'s current
    stream; raise on a launch error."""
    lib = st_kernel._load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _rows(t: torch.Tensor | None, shape) -> torch.Tensor | None:
    """A cotangent as the kernel reads it: ``shape``, inner stride 1."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"want a cotangent {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t if t.stride(1) == 1 else t.contiguous()


def lstm_cell_cuda(a: torch.Tensor, b: torch.Tensor, c_prev: torch.Tensor):
    """Launch the forward kernel: ``(c, h)``, each ``(rows, H)``
    contiguous, bit-equal to ``lstm_cell_plain``."""
    _check("lstm_cell_cuda", a, b, c_prev)
    rows, hidden = c_prev.shape
    c = torch.empty((rows, hidden), dtype=torch.float32, device=a.device)
    h = torch.empty_like(c)
    if rows and hidden:
        _launch("lstm_cell", a.device, a.data_ptr(), b.data_ptr(),
                c_prev.data_ptr(), c_prev.stride(0), c.data_ptr(),
                h.data_ptr(), rows, hidden)
    return c, h


def lstm_cell_bwd_cuda(a: torch.Tensor, b: torch.Tensor, c_prev: torch.Tensor,
                       dh: torch.Tensor | None, dc: torch.Tensor | None,
                       need_c_prev: bool = True):
    """Launch the backward kernel: ``(d_gates (rows, 4H), dc_prev (rows,
    H) or None)`` from the cotangents of ``h`` and ``c``, either None
    where absent (not both), bit-equal to ``lstm_cell_bwd_plain``.
    ``d_gates`` is the gradient of ``a`` and of ``b``."""
    _check("lstm_cell_bwd_cuda", a, b, c_prev)
    if dh is None and dc is None:
        raise ValueError("lstm_cell_bwd_cuda needs dh or dc")
    rows, hidden = c_prev.shape
    dh, dc = _rows(dh, c_prev.shape), _rows(dc, c_prev.shape)
    if any(t is not None and (t.device != a.device or t.dtype != a.dtype)
           for t in (dh, dc)):
        raise ValueError("lstm_cell_bwd_cuda takes float32 cotangents on "
                         "the inputs' device")
    d_gates = torch.empty_like(a)
    dc_prev = (torch.empty((rows, hidden), dtype=torch.float32,
                           device=a.device) if need_c_prev else None)
    if rows and hidden:
        def ptr(t):
            return None if t is None else t.data_ptr()

        _launch("lstm_cell_bwd", a.device, a.data_ptr(), b.data_ptr(),
                c_prev.data_ptr(), c_prev.stride(0),
                ptr(dh), 0 if dh is None else dh.stride(0),
                ptr(dc), 0 if dc is None else dc.stride(0),
                d_gates.data_ptr(), ptr(dc_prev), rows, hidden)
    return d_gates, dc_prev


def _activations(a, b):
    i, f, g, o = (a + b).chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def lstm_cell_plain(a: torch.Tensor, b: torch.Tensor, c_prev: torch.Tensor):
    """The forward kernel's function as the unfused ops: ``(c, h)``."""
    si, sf, tg, so = _activations(a, b)
    c = sf * c_prev + si * tg
    return c, so * torch.tanh(c)


def lstm_cell_bwd_plain(a: torch.Tensor, b: torch.Tensor,
                        c_prev: torch.Tensor, dh: torch.Tensor | None,
                        dc: torch.Tensor | None, need_c_prev: bool = True):
    """The backward kernel's function as autograd computes it for the
    unfused ops: ``sigmoid_backward`` and ``tanh_backward``, each product's
    backward one product, c's gradients through ``h`` and from ``dc``
    summed once, the split's backward a concatenation with zeros for the
    o gate where ``dh`` is absent."""
    si, sf, tg, so = _activations(a, b)
    sig_bwd = torch.ops.aten.sigmoid_backward
    tanh_bwd = torch.ops.aten.tanh_backward
    if dh is None:
        d_o, dct = torch.zeros_like(so), dc
    else:
        tc = torch.tanh(sf * c_prev + si * tg)
        d_o = sig_bwd(dh * tc, so)
        through_h = tanh_bwd(dh * so, tc)
        dct = through_h if dc is None else dc + through_h
    d_gates = torch.cat([sig_bwd(dct * tg, si), sig_bwd(dct * c_prev, sf),
                         tanh_bwd(dct * si, tg), d_o], dim=-1)
    return d_gates, (dct * sf if need_c_prev else None)
