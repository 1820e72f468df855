"""The bilinear gather kernel on the card: build, binding, count, plain twin.

``csrc/st_gather.cu`` is the hand-written CUDA counterpart of the Pallas
``_gather_kernel`` (``attend_infer_repeat_tpu/ops/pallas_st.py``).  This
module compiles it with ``nvcc`` for ``sm_90a`` at first use into a
shared library with a plain C interface (cached by source hash under
``attend_infer_repeat_torch/_build/``), loads it with ``ctypes`` and
launches it on PyTorch's current stream.

``st_gather_cuda`` takes CUDA tensors only and launches the kernel or
raises; ``st_gather_plain`` is the same function in plain PyTorch (the
separable einsum with materialized hat weights), used for CPU tensors and
as the kernel's yardstick on the card.  ``launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from attend_infer_repeat_torch.ops.spatial_transformer import st_weights

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "st_gather.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Number of kernel launches since the count was last set to 0.
launches = 0
_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/st_gather.cu")
    return nvcc


def build() -> Path:
    """Compile the kernel (once per source version); return the library.

    The compiler's report (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``<name>.log``.
    """
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libst_gather_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.st_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # img zw out
            ctypes.c_longlong,                                    # n
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,                                         # bf16
            ctypes.c_void_p]                                      # stream
        lib.st_gather.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_compute_dtype(compute_dtype: str) -> bool:
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def st_gather_cuda(img: torch.Tensor, zw: torch.Tensor, out_shape,
                   compute_dtype: str = "float32") -> torch.Tensor:
    """Launch the kernel: ``img (N, H, W)``, ``zw (N, 4)`` → ``(N, h, w)``.

    Both inputs must be contiguous float32 CUDA tensors on one device.
    Forward only: the backward kernel is not ported yet, so a call that
    autograd would have to differentiate raises.
    """
    global launches
    bf16 = _check_compute_dtype(compute_dtype)
    if not (img.is_cuda and zw.is_cuda and img.device == zw.device):
        raise ValueError("st_gather_cuda takes CUDA tensors on one device")
    if img.dtype != torch.float32 or zw.dtype != torch.float32:
        raise TypeError(f"st_gather_cuda takes float32, got {img.dtype} "
                        f"and {zw.dtype}")
    if img.dim() != 3 or tuple(zw.shape) != (img.shape[0], 4):
        raise ValueError(f"want img (N, H, W) and zw (N, 4), got "
                         f"{tuple(img.shape)} and {tuple(zw.shape)}")
    if img.shape[0] >= 2 ** 31:
        raise ValueError("st_gather_cuda takes N < 2**31 (one block each)")
    if not (img.is_contiguous() and zw.is_contiguous()):
        raise ValueError("st_gather_cuda takes contiguous tensors")
    if torch.is_grad_enabled() and (img.requires_grad or zw.requires_grad):
        raise NotImplementedError(
            "the gather's backward kernel is not ported yet; call under "
            "torch.inference_mode() or torch.no_grad()")
    n, in_h, in_w = img.shape
    out_h, out_w = (int(s) for s in out_shape)
    out = torch.empty((n, out_h, out_w), dtype=torch.float32,
                      device=img.device)
    if n == 0 or out_h * out_w == 0:
        return out
    lib = _load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.st_gather(img.data_ptr(), zw.data_ptr(), out.data_ptr(),
                            n, in_h, in_w, out_h, out_w, int(bf16), stream)
    if err:
        raise RuntimeError(f"st_gather kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def st_gather_plain(img: torch.Tensor, zw: torch.Tensor, out_shape,
                    compute_dtype: str = "float32") -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``W_y · img · W_xᵀ``.

    ``bfloat16`` mode rounds the weights, the pixels and the row-pass
    intermediate to bf16 as the kernel does, and accumulates in f32.
    """
    bf16 = _check_compute_dtype(compute_dtype)
    w_y, w_x = st_weights(zw, out_shape, img.shape[-2:])
    if bf16:
        def rnd(t):
            return t.to(torch.bfloat16).to(torch.float32)
        tmp = rnd(torch.matmul(rnd(w_y), rnd(img)))
        return torch.matmul(tmp, rnd(w_x).transpose(-1, -2))
    return torch.matmul(torch.matmul(w_y, img), w_x.transpose(-1, -2))
