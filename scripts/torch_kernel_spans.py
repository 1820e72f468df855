"""Where a kernel launch's time goes: fixed cost, block latency, slowest block.

Builds instrumented copies of the port's two kernel sources (each kernel
reads the card's global timer when its block starts and when it ends), runs
them on the windows of a train step (``chip_smoke.WINDOW_CASES``' step-like
windows) and of serving, and prints per case: the launch's device time
(CUDA events behind a sleep kernel, as ``chip_smoke.cuda_ms``), the span
from the first block's start to the last block's end, the mean and largest
block duration, and how late the blocks start.  Launch time minus span is
the launch's fixed cost; span minus the mean block is what the slowest
blocks add.  Needs one CUDA card and ``nvcc``::

    python3 scripts/torch_kernel_spans.py

The instrumented copies are built under
``attend_infer_repeat_torch/_build/spans/``, beside (not in place of) the
port's own library.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "attend_infer_repeat_torch" / "csrc"
TIMER = """
__device__ __forceinline__ unsigned long long block_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ unsigned long long* g_spans = nullptr;
extern "C" int set_spans(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_spans, &p, sizeof(p)));
}
"""
RECORD = ("if (threadIdx.x == 0 && g_spans) { g_spans[2 * blockIdx.x] = "
          "t_start; g_spans[2 * blockIdx.x + 1] = block_clock(); }")


def instrument(src: str, kernels) -> str:
    """``src`` with each named kernel recording its block's start and end
    (every ``return`` of its body included)."""
    src = src.replace('#include "st_taps.cuh"',
                      '#include "st_taps.cuh"\n' + TIMER)
    for name in kernels:
        start = src.index("{\n", src.index(name + "(")) + 2
        end = src.index("\n}\n", start)
        body = src[start:end].replace(
            "  if (!with_img) return;",
            "  if (!with_img) {\n    " + RECORD + "\n    return;\n  }")
        src = (src[:start] + "  const unsigned long long t_start = "
               "block_clock();\n" + body + "\n  " + RECORD + src[end:])
    return src


def build(src: str, out: Path):
    from attend_infer_repeat_torch.ops.st_kernel import NVCC_FLAGS, _nvcc

    out.mkdir(parents=True, exist_ok=True)
    (out / "k.cu").write_text(src)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-I", str(CSRC), "-o",
                           str(out / "lib.so"), str(out / "k.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.set_spans.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_spans: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from attend_infer_repeat_torch.ops.spatial_transformer import (
        invert_where)
    from attend_infer_repeat_torch.ops.st_kernel import BUILD_DIR

    print(cs.nvidia_smi(), flush=True)
    scratch = BUILD_DIR / "spans"
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = build(instrument((CSRC / "st_gather.cu").read_text(),
                           ["st_gather_kernel"]), scratch / "fwd")
    fwd.st_gather.argtypes = [p, p, p, ctypes.c_longlong] + [i32] * 5 + [p]
    bwd = build(instrument((CSRC / "st_gather_bwd.cu").read_text(),
                           ["st_gather_bwd_kernel",
                            "st_gather_bwd_dense_kernel"]), scratch / "bwd")
    bwd.st_gather_bwd.argtypes = ([p] * 5 + [ctypes.c_longlong] + [i32] * 5
                                  + [p])
    gen = torch.Generator("cuda").manual_seed(0)
    cases = [  # name, windows, input, output, paste, N, backward?, g_img?
        ("step gather", "step-like windows", (50, 50), (20, 20), False,
         1024, False, False),
        ("step paste", "step-like windows", (20, 20), (50, 50), True, 1024,
         False, False),
        ("serving gather", None, (50, 50), (20, 20), False, 8192, False,
         False),
        ("serving paste", None, (20, 20), (50, 50), True, 8192, False,
         False),
        ("step gather bwd, g_zw only", "step-like windows", (50, 50),
         (20, 20), False, 1024, True, False),
        ("step paste bwd", "step-like windows", (20, 20), (50, 50), True,
         1024, True, True),
    ]
    for name, kind, ins, outs, paste, n, backward, need_img in cases:
        img = torch.rand((n,) + ins, generator=gen, device="cuda")
        if kind:
            zw = cs.branch_where(kind, n, ins, outs, paste, gen,
                                 invert_where)
        else:
            zw = cs.random_where(n, gen)
            zw = invert_where(zw).contiguous() if paste else zw
        stream = torch.cuda.current_stream().cuda_stream
        if backward:
            lib = bwd
            g = torch.randn((n,) + outs, generator=gen, device="cuda")
            g_zw = torch.empty((n, 4), device="cuda")
            g_img = (torch.empty((n,) + ins, device="cuda") if need_img
                     else None)

            def call():
                return lib.st_gather_bwd(
                    img.data_ptr(), zw.data_ptr(), g.data_ptr(),
                    None if g_img is None else g_img.data_ptr(),
                    g_zw.data_ptr(), n, *ins, *outs, 0, stream)
        else:
            lib = fwd
            out = torch.empty((n,) + outs, device="cuda")

            def call():
                return lib.st_gather(img.data_ptr(), zw.data_ptr(),
                                     out.data_ptr(), n, *ins, *outs, 0,
                                     stream)
        us = cs.cuda_ms(call) * 1e3
        spans = torch.zeros((n, 2), dtype=torch.int64, device="cuda")
        lib.set_spans(spans.data_ptr())
        if call():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        lib.set_spans(None)
        t = (spans - spans[:, 0].min()).double() / 1e3          # us
        dur = t[:, 1] - t[:, 0]
        starts = t[:, 0].sort().values
        print(f"{name} N={n}: launch {us:.2f} us; span "
              f"{t[:, 1].max().item():.2f} us; block mean "
              f"{dur.mean().item():.2f} us, max {dur.max().item():.2f} us; "
              f"block starts p50 {starts[n // 2].item():.2f} us, last "
              f"{starts[-1].item():.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
