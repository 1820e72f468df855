"""Time the LSTM cell's fused pointwise kernels against the unfused ops
and against PyTorch's own fused cell.

For each row count of ``chip_smoke.LSTM_ROWS`` (1,024: AIR's train batch;
5,120: k = 5 particles of 1,024, as in ``iwae_trained`` and SQAIR; 8,192:
a bulk request) at the hidden width 256, on inputs made from a seed, runs
``chip_smoke.lstm_phase``:

- holds ``lstm_cell_cuda`` and ``lstm_cell_bwd_cuda`` bit for bit to their
  plain twins (``c_prev`` strided and contiguous; both cotangents, ``dh``
  absent, ``dc`` absent), and raises where they differ;
- counts the bits in which PyTorch's fused cell
  (``aten._thnn_fused_lstm_cell`` and its backward, ``nn.LSTMCell``'s
  kernels on CUDA) differs from the unfused ops;
- times the fused forward and backward, the unfused forward, autograd's
  backward of the unfused ops and PyTorch's fused cell each way, with
  CUDA events over 20 launches queued behind a sleep kernel
  (``chip_smoke.cuda_ms``), cycling through enough input sets, each with
  its own cotangents, that each launch reads its inputs from device
  memory and not from the 50 MB L2;
- gives each kernel's bound: the bytes it must move (inputs read once,
  outputs written once) at 3.35 TB/s.

Then counts the kernels of one unfused forward and backward, and of the
fused ones, with ``torch.profiler``.

Needs one CUDA card and ``nvcc``::

    python3 scripts/torch_lstm_ab.py

Prints one JSON line a row count and kernel, and writes them all to
``chiprun_out/lstm_ab.json`` under the working directory.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def kernels_of(fn) -> int:
    """Device kernels that one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def kernel_counts(rows: int, hidden: int) -> dict:
    """Kernels of one call each way: unfused, fused, PyTorch's cell."""
    import chip_smoke as cs
    from attend_infer_repeat_torch.ops import lstm_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b, slot, dh, dc = cs.lstm_inputs(rows, hidden, gen)
    c_prev = slot.contiguous()
    ga, gb, gc = (t.detach().requires_grad_() for t in (a, b, c_prev))
    c, h = lstm_kernel.lstm_cell_plain(ga, gb, gc)
    lib_c, _, workspace = cs.library_lstm(a, b, c_prev)
    return {
        "unfused_fwd": kernels_of(
            lambda: lstm_kernel.lstm_cell_plain(a, b, c_prev)),
        "unfused_bwd": kernels_of(lambda: torch.autograd.grad(
            (c, h), (ga, gb, gc), (dc, dh), retain_graph=True)),
        "fused_fwd": kernels_of(
            lambda: lstm_kernel.lstm_cell_cuda(a, b, c_prev)),
        "fused_bwd": kernels_of(
            lambda: lstm_kernel.lstm_cell_bwd_cuda(a, b, c_prev, dh, dc)),
        "torch_fused_cell_fwd": kernels_of(
            lambda: cs.library_lstm(a, b, c_prev)),
        "torch_fused_cell_bwd": kernels_of(
            lambda: cs.library_lstm_bwd(dh, dc, c_prev, lib_c, workspace)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    smi = cs.nvidia_smi()
    print(smi, torch.__version__, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    bw, f32_peak = cs.card_peaks(torch.cuda.get_device_name(0))
    fwd, bwd = cs.lstm_phase(bw, f32_peak)
    lines = [dict(r, card=smi) for r in fwd + bwd]
    lines.append({"kernels_per_call": kernel_counts(cs.LSTM_ROWS[1],
                                                    cs.LSTM_HIDDEN),
                  "rows": cs.LSTM_ROWS[1], "card": smi})
    for line in lines:
        print(json.dumps(line), flush=True)
    out = Path.cwd() / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lstm_ab.json").write_text(json.dumps(lines, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
