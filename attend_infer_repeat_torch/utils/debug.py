"""NaN trapping and functional error checks on the estimator path.

``debug_mode`` is the counterpart of ``jax_debug_nans``: any operation
whose floating-point output holds a NaN raises ``FloatingPointError``,
in the forward and in the backward (a dispatch mode sees every ATen
operation of both; autograd's anomaly mode adds the forward's traceback
to an error raised in the backward).  Inside it the graphed entry points
run eagerly (``utils.graphs.eager``), as ``jax_disable_jit`` would, since
a replayed CUDA graph runs no Python to check.  ``checkify_fn`` records the first
NaN or division by zero instead of raising.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# outputs that hold uninitialized memory, not results
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}
_state = threading.local()


def active() -> bool:
    """Whether a ``debug_mode`` block is open on this thread."""
    return getattr(_state, "depth", 0) > 0


class _FloatChecks(TorchDispatchMode):
    """Check each ATen operation's floating-point outputs for NaN, and its
    divisions for a zero divisor (``div_checks``); raise, or record the
    first finding."""

    def __init__(self, raise_on_nan: bool = True, div_checks: bool = False):
        super().__init__()
        self.raise_on_nan = raise_on_nan
        self.div_checks = div_checks
        self.error: Optional[str] = None

    def _found(self, msg: str) -> None:
        if self.raise_on_nan:
            raise FloatingPointError(msg)
        if self.error is None:
            self.error = msg

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if self.div_checks and name in ("div", "div_") and len(args) > 1:
            d = args[1]
            if (d == 0).any() if isinstance(d, torch.Tensor) else d == 0:
                self._found(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if name not in _UNINITIALIZED:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and torch.isnan(t).any()):
                    self._found(f"NaN in the output of {func}")
                    break
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Trap NaNs (``nans``) for a block; CUDA graphs are off inside it.

    ``disable_jit`` keeps the JAX package's interface: the steps inside a
    ``debug_mode`` block already run eagerly.
    """
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        if nans:
            with torch.autograd.set_detect_anomaly(True, check_nan=True), \
                    _FloatChecks(raise_on_nan=True):
                yield
        else:
            yield
    finally:
        _state.depth -= 1


class CheckError:
    """What ``checkify_fn`` found: ``get()`` is its message or None,
    ``throw()`` raises it as ``FloatingPointError``."""

    def __init__(self, msg: Optional[str]):
        self.msg = msg

    def get(self) -> Optional[str]:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise FloatingPointError(self.msg)


def checkify_fn(fn):
    """``fn`` with floating-point checks (a NaN output, a division by
    zero): the wrapped call returns ``(err, out)``; ``err.throw()``
    raises what was found."""

    def checked(*args, **kwargs):
        mode = _FloatChecks(raise_on_nan=False, div_checks=True)
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.error), out

    return checked
