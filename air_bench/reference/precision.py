"""How the reference computes a product of a stated precision.

A configuration states the precision of each matmul: ``dtype`` for the
inference network and the baseline, ``decoder_dtype`` for the decoder,
float32 for the LSTM, the presence logit and the spatial transformer.
``Precision()`` computes each as stated (bfloat16 operands and bias, or
float32 with TF32 off).  ``Precision(lower=True)`` is the control: every
product one step below what is stated, bfloat16 as fp8 (e4m3, one scale a
tensor) and float32 as TF32 (operands rounded to TF32's 10-bit mantissa,
then an exact float32 product, so that the CPU computes what the card's
TF32 units would).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10-bit mantissa)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through fp8 e4m3 with one scale for the tensor, back in its
    own dtype."""
    scale = torch.clamp(x.detach().abs().amax().float(), min=1e-30) / E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class Precision:
    """The products of the reference, as stated or one step below."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def _operands(self, dtype, *ts):
        out = []
        for t in ts:
            t = t.to(dtype)
            if self.lower:
                t = fp8_round(t) if dtype == torch.bfloat16 else \
                    t + (tf32_round(t.detach()) - t.detach())
            out.append(t)
        return out

    def linear(self, x, w, b, dtype):
        """``x @ w.T + b`` in the stated ``dtype``."""
        x, w = self._operands(dtype, x, w)
        return F.linear(x, w, None if b is None else b.to(dtype))

    def mm(self, a, b, dtype=torch.float32):
        """``a @ b`` in the stated ``dtype``."""
        a, b = self._operands(dtype, a, b)
        return torch.matmul(a, b)
