"""The gather kernels on the card: build, binding, counts, plain twins.

``csrc/st_gather.cu`` is the hand-written CUDA counterpart of the Pallas
``_gather_kernel`` and ``csrc/st_gather_bwd.cu`` of its backward
``_gather_bwd_kernel`` (both in ``attend_infer_repeat_tpu/ops/pallas_st.py``).
This module compiles both, and ``csrc/lstm_cell.cu`` (the LSTM cell's
pointwise kernels, bound in ``ops/lstm_kernel.py``), with one ``nvcc``
call for ``sm_90a`` at first use, into one shared library with a plain C
interface (cached by a hash of all sources under
``attend_infer_repeat_torch/_build/``), loads it with ``ctypes`` and
launches on PyTorch's current stream.

``st_gather_cuda`` and ``st_gather_bwd_cuda`` take CUDA tensors only and
launch their kernel or raise; ``st_gather_plain`` and
``st_gather_bwd_plain`` are the same functions in plain PyTorch (dense
einsums with materialized hat weights), used for CPU tensors and as the
kernels' yardsticks on the card.  ``STGather`` is the autograd glue: its
forward and backward take the kernel for CUDA tensors and the plain
version for CPU tensors.

``st_gather_accumulate_cuda`` is a paste fused with the canvas update
that follows it in the model's cell, ``carry(f32(canvas) + z_pres ·
paste)`` in one pass (``st_gather_accumulate_kernel`` in
``csrc/st_gather.cu``), bit-equal to the unfused ops;
``st_gather_accumulate_plain`` is those ops, and ``STGatherAccumulate``
its autograd glue, whose backward is the gather's backward kernel.

The indexed gather takes many windows of one image with no copy of the
image per window: given ``src (N,)`` int32, glimpse n reads image
``src[n]`` of ``img (M, H, W)`` (``st_gather_cuda(..., src=src)``, float32
mode), and its backward gives ``g_zw`` alone (the images are data; asking
for ``g_img`` raises).  Without ``src`` every launch is the one-to-one
gather it always was.

``launches`` and ``bwd_launches`` count kernel launches, and nothing
else (a fused paste is a forward launch); ``shape_launches`` counts them
by shape, an indexed launch under its own kernel name
(``st_gather_indexed``, ``st_gather_bwd_indexed``, with N the windows
and ``(H, W)`` an image's).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from attend_infer_repeat_torch.ops.spatial_transformer import (
    _axis_weights_and_dp,
    st_weights,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "st_gather.cu"
BWD_SOURCE = _PKG / "csrc" / "st_gather_bwd.cu"
LSTM_SOURCE = _PKG / "csrc" / "lstm_cell.cu"
SOURCES = (_PKG / "csrc" / "st_taps.cuh", SOURCE, BWD_SOURCE, LSTM_SOURCE)
DEFAULT_BUILD_DIR = _PKG / "_build"
#: Where ``build`` puts the library (``utils.enable_compilation_cache``).
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Number of forward kernel launches (gathers and fused pastes) since the
#: count was last set to 0.
launches = 0
#: Number of backward kernel launches since the count was last set to 0.
bwd_launches = 0
#: Launches of each kernel by ``(kernel, N, H, W, h, w)``, ``kernel``
#: "st_gather", "st_gather_accumulate", "st_gather_bwd",
#: "st_gather_indexed" or "st_gather_bwd_indexed", since the counter was
#: last cleared.
shape_launches: collections.Counter = collections.Counter()
_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in csrc/")
    return nvcc


def build() -> Path:
    """Compile the kernels (once per source version); return the library.

    The compiler's report (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``<name>.log``.
    """
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libst_gather_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE),
                           str(BWD_SOURCE), str(LSTM_SOURCE)],
                          capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SOURCE.parent}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.st_gather.argtypes = [
            ptr, ptr, ptr,                          # img zw out
            ctypes.c_longlong,                      # n
            i32, i32, i32, i32,                     # in_h in_w out_h out_w
            i32,                                    # bf16
            ptr]                                    # stream
        lib.st_gather.restype = i32
        lib.st_gather_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr,                # img zw g gimg gzw
            ctypes.c_longlong, i32, i32, i32, i32, i32, ptr]
        lib.st_gather_bwd.restype = i32
        lib.st_gather_accumulate.argtypes = [
            ptr, ptr, ptr, ptr, ptr,                # canvas glimpse zw z out
            ctypes.c_longlong, i32, i32, i32, i32,  # n in_h in_w out_h out_w
            i32, ptr]                               # carry_bf16 stream
        lib.st_gather_accumulate.restype = i32
        lib.st_gather_indexed.argtypes = [
            ptr, ptr, ptr, ptr,                     # img src zw out
            ctypes.c_longlong, i32, i32, i32, i32,  # n in_h in_w out_h out_w
            ptr]                                    # stream
        lib.st_gather_indexed.restype = i32
        lib.st_gather_bwd_indexed.argtypes = [
            ptr, ptr, ptr, ptr, ptr,                # img src zw g gzw
            ctypes.c_longlong, i32, i32, i32, i32, ptr]
        lib.st_gather_bwd_indexed.restype = i32
        i64 = ctypes.c_longlong
        lib.lstm_cell.argtypes = [
            ptr, ptr, ptr, i64,                     # a b c_prev its stride
            ptr, ptr, i64, i32, ptr]                # c h rows hidden stream
        lib.lstm_cell.restype = i32
        lib.lstm_cell_bwd.argtypes = [
            ptr, ptr, ptr, i64,                     # a b c_prev its stride
            ptr, i64, ptr, i64,                     # dh, dc and strides
            ptr, ptr, i64, i32, ptr]                # d_gates dc_prev rows ...
        lib.lstm_cell_bwd.restype = i32
        _lib = lib
    return _lib


def _check_compute_dtype(compute_dtype: str) -> bool:
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def _check_cuda(name: str, **tensors) -> None:
    """Device, type and contiguity checks shared by both wrappers."""
    ts = list(tensors.values())
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes float32, got "
                        f"{', '.join(str(t.dtype) for t in ts)}")
    img, zw = tensors["img"], tensors["zw"]
    if img.dim() != 3 or tuple(zw.shape) != (img.shape[0], 4):
        raise ValueError(f"want img (N, H, W) and zw (N, 4), got "
                         f"{tuple(img.shape)} and {tuple(zw.shape)}")
    if img.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} takes N < 2**31 (one block each)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_src(name: str, img: torch.Tensor, zw: torch.Tensor,
               src: torch.Tensor, compute_dtype: str) -> None:
    """The indexed launch's checks: ``img (M, H, W)``, ``zw (N, 4)`` and
    ``src (N,)`` int32, contiguous on one CUDA device, float32 mode."""
    if compute_dtype != "float32":
        raise ValueError(f"{name} with src runs in float32 mode only")
    if not (img.is_cuda and zw.is_cuda and src.is_cuda
            and img.device == zw.device == src.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if img.dtype != torch.float32 or zw.dtype != torch.float32 \
            or src.dtype != torch.int32:
        raise TypeError(f"{name} takes float32 img and zw and int32 src, "
                        f"got {img.dtype}, {zw.dtype}, {src.dtype}")
    if img.dim() != 3 or zw.dim() != 2 or zw.shape[1] != 4 \
            or tuple(src.shape) != (zw.shape[0],):
        raise ValueError(f"want img (M, H, W), zw (N, 4) and src (N,), got "
                         f"{tuple(img.shape)}, {tuple(zw.shape)} and "
                         f"{tuple(src.shape)}")
    if zw.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} takes N < 2**31 (one block each)")
    if not (img.is_contiguous() and zw.is_contiguous()
            and src.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def st_gather_cuda(img: torch.Tensor, zw: torch.Tensor, out_shape,
                   compute_dtype: str = "float32",
                   src: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: ``img (N, H, W)``, ``zw (N, 4)`` → ``(N, h, w)``.

    Both inputs must be contiguous float32 CUDA tensors on one device.
    With ``src (N,)`` int32 the gather is indexed: ``img (M, H, W)`` and
    output n is the gather of ``img[src[n]]`` at ``zw[n]`` (float32 mode).
    Not differentiable by itself: ``STGather`` wraps it.
    """
    global launches
    if src is not None:
        return _st_gather_indexed(img, zw, src, out_shape, compute_dtype)
    bf16 = _check_compute_dtype(compute_dtype)
    _check_cuda("st_gather_cuda", img=img, zw=zw)
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
    shape_launches["st_gather", n, in_h, in_w, out_h, out_w] += 1
    return out


def _st_gather_indexed(img, zw, src, out_shape, compute_dtype):
    global launches
    _check_src("st_gather_cuda", img, zw, src, compute_dtype)
    n, (_, in_h, in_w) = zw.shape[0], img.shape
    out_h, out_w = (int(s) for s in out_shape)
    out = torch.empty((n, out_h, out_w), dtype=torch.float32,
                      device=img.device)
    if n == 0 or out_h * out_w == 0:
        return out
    lib = _load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.st_gather_indexed(img.data_ptr(), src.data_ptr(),
                                    zw.data_ptr(), out.data_ptr(), n, in_h,
                                    in_w, out_h, out_w, stream)
    if err:
        raise RuntimeError(f"st_gather_indexed kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    shape_launches["st_gather_indexed", n, in_h, in_w, out_h, out_w] += 1
    return out


def st_gather_plain(img: torch.Tensor, zw: torch.Tensor, out_shape,
                    compute_dtype: str = "float32",
                    src: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``W_y · img · W_xᵀ``.

    ``bfloat16`` mode rounds the weights, the pixels and the row-pass
    intermediate to bf16 as the kernel does, and accumulates in f32.
    With ``src`` the images are ``img[src]``.
    """
    if src is not None:
        img = img[src.long()]
    bf16 = _check_compute_dtype(compute_dtype)
    w_y, w_x = st_weights(zw, out_shape, img.shape[-2:])
    if bf16:
        def rnd(t):
            return t.to(torch.bfloat16).to(torch.float32)
        tmp = rnd(torch.matmul(rnd(w_y), rnd(img)))
        return torch.matmul(tmp, rnd(w_x).transpose(-1, -2))
    return torch.matmul(torch.matmul(w_y, img), w_x.transpose(-1, -2))


def st_gather_bwd_cuda(img: torch.Tensor, zw: torch.Tensor, g: torch.Tensor,
                       out_shape, compute_dtype: str = "float32",
                       need_img: bool = True,
                       src: torch.Tensor | None = None):
    """Launch the backward kernel: the VJP of ``st_gather_cuda``.

    ``img (N, H, W)``, ``zw (N, 4)`` and the output cotangent
    ``g (N, h, w)`` → ``(g_img (N, H, W) or None, g_zw (N, 4))``, with
    ``g_zw`` ordered ``(d_sx, d_sy, d_tx, d_ty)``.  ``need_img=False``
    skips ``g_img`` (returned as None).  All three inputs must be
    contiguous float32 CUDA tensors on one device.  With ``src`` (the
    indexed gather's, float32 mode) it gives ``(None, g_zw)``, and raises
    if ``need_img``: the images are data.
    """
    global bwd_launches
    if src is not None:
        return _st_gather_bwd_indexed(img, zw, g, src, out_shape,
                                      compute_dtype, need_img)
    bf16 = _check_compute_dtype(compute_dtype)
    _check_cuda("st_gather_bwd_cuda", img=img, zw=zw, g=g)
    n, in_h, in_w = img.shape
    out_h, out_w = (int(s) for s in out_shape)
    if tuple(g.shape) != (n, out_h, out_w):
        raise ValueError(f"want g {(n, out_h, out_w)}, got {tuple(g.shape)}")
    dev = img.device
    g_img = (torch.empty((n, in_h, in_w), dtype=torch.float32, device=dev)
             if need_img else None)
    g_zw = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0 or out_h * out_w == 0 or in_h * in_w == 0:
        if need_img:
            g_img.zero_()
        return g_img, g_zw.zero_()
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.st_gather_bwd(
            img.data_ptr(), zw.data_ptr(), g.data_ptr(),
            g_img.data_ptr() if need_img else None, g_zw.data_ptr(),
            n, in_h, in_w, out_h, out_w, int(bf16), stream)
    if err:
        raise RuntimeError(f"st_gather_bwd kernel launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1
    shape_launches["st_gather_bwd", n, in_h, in_w, out_h, out_w] += 1
    return g_img, g_zw


def _st_gather_bwd_indexed(img, zw, g, src, out_shape, compute_dtype,
                           need_img):
    global bwd_launches
    if need_img:
        raise ValueError("the indexed gather's images are data: it has no "
                         "image gradient (need_img=False)")
    _check_src("st_gather_bwd_cuda", img, zw, src, compute_dtype)
    n, (_, in_h, in_w) = zw.shape[0], img.shape
    out_h, out_w = (int(s) for s in out_shape)
    if tuple(g.shape) != (n, out_h, out_w) or g.dtype != torch.float32 \
            or not g.is_contiguous() or g.device != img.device:
        raise ValueError(f"want g {(n, out_h, out_w)} float32, contiguous, "
                         f"on {img.device}; got {tuple(g.shape)} {g.dtype}")
    g_zw = torch.empty((n, 4), dtype=torch.float32, device=img.device)
    if n == 0 or out_h * out_w == 0 or in_h * in_w == 0:
        return None, g_zw.zero_()
    lib = _load()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.st_gather_bwd_indexed(
            img.data_ptr(), src.data_ptr(), zw.data_ptr(), g.data_ptr(),
            g_zw.data_ptr(), n, in_h, in_w, out_h, out_w, stream)
    if err:
        raise RuntimeError(f"st_gather_bwd_indexed kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches += 1
    shape_launches["st_gather_bwd_indexed", n, in_h, in_w, out_h, out_w] += 1
    return None, g_zw


def st_gather_bwd_plain(img: torch.Tensor, zw: torch.Tensor, g: torch.Tensor,
                        out_shape, compute_dtype: str = "float32",
                        need_img: bool = True,
                        src: torch.Tensor | None = None):
    """The backward kernel's function in plain PyTorch.

    The five contractions of the Pallas ``_gather_bwd_kernel`` on
    materialized weights and their ``dW/dp``.  ``bfloat16`` mode rounds
    each contraction's two operands to bf16 and accumulates in f32, as
    the Pallas kernel's ``dot`` does.  With ``src`` the images are
    ``img[src]`` and ``need_img`` raises, as the indexed kernel does.
    """
    if src is not None:
        if need_img:
            raise ValueError("the indexed gather's images are data: it has "
                             "no image gradient (need_img=False)")
        img = img[src.long()]
    bf16 = _check_compute_dtype(compute_dtype)
    (out_h, out_w), (in_h, in_w) = out_shape, img.shape[-2:]
    w_y, dwy, u_y = _axis_weights_and_dp(zw[:, 1], zw[:, 3], out_h, in_h)
    w_x, dwx, u_x = _axis_weights_and_dp(zw[:, 0], zw[:, 2], out_w, in_w)

    def dot(a, b):
        if bf16:
            a = a.to(torch.bfloat16).to(torch.float32)
            b = b.to(torch.bfloat16).to(torch.float32)
        return torch.matmul(a, b)

    g_img = None
    if need_img:
        # g_img[j,l] = Σ_i w_y[i,j] Σ_k g[i,k] w_x[k,l]
        g_img = dot(dot(w_y.transpose(-1, -2), g), w_x)        # (N, H, W)
    tmp = dot(w_y, img)                                        # (N, h, W)
    g_wx = dot(g.transpose(-1, -2), tmp)                       # (N, w, W)
    gx = dot(img, w_x.transpose(-1, -2))                       # (N, H, w)
    g_wy = dot(g, gx.transpose(-1, -2))                        # (N, h, H)
    cy, cx = (in_h - 1) / 2.0, (in_w - 1) / 2.0
    gy = torch.sum(g_wy * dwy, dim=-1)                         # (N, h)
    gxw = torch.sum(g_wx * dwx, dim=-1)                        # (N, w)
    g_zw = torch.stack([torch.sum(gxw * u_x, dim=-1) * cx,
                        torch.sum(gy * u_y, dim=-1) * cy,
                        torch.sum(gxw, dim=-1) * cx,
                        torch.sum(gy, dim=-1) * cy], dim=-1)
    return g_img, g_zw


def st_gather_accumulate_cuda(canvas: torch.Tensor, glimpse: torch.Tensor,
                              zw: torch.Tensor,
                              z_pres: torch.Tensor) -> torch.Tensor:
    """Launch the fused paste: a new canvas
    ``carry(f32(canvas) + z_pres · st_gather(glimpse, zw, (H, W)))``.

    ``canvas (N, H, W)`` float32 or bfloat16 (the carry, also the
    result's dtype), ``glimpse (N, h, w)``, ``zw (N, 4)`` (the inverted
    window) and ``z_pres (N,)`` float32: contiguous CUDA tensors on one
    device.  Bit-equal to ``st_gather_accumulate_plain`` with the paste
    from ``st_gather_cuda``.  Not differentiable by itself:
    ``STGatherAccumulate`` wraps it.
    """
    global launches
    _check_cuda("st_gather_accumulate_cuda", img=glimpse, zw=zw,
                z_pres=z_pres)
    n, in_h, in_w = glimpse.shape
    if not (canvas.is_cuda and canvas.device == glimpse.device):
        raise ValueError("st_gather_accumulate_cuda takes CUDA tensors on "
                         "one device")
    if canvas.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"st_gather_accumulate_cuda takes a float32 or "
                        f"bfloat16 canvas, got {canvas.dtype}")
    if canvas.dim() != 3 or canvas.shape[0] != n or tuple(z_pres.shape) != (
            n,):
        raise ValueError(f"want canvas (N, H, W) and z_pres (N,) for N = {n},"
                         f" got {tuple(canvas.shape)} and "
                         f"{tuple(z_pres.shape)}")
    if not canvas.is_contiguous():
        raise ValueError("st_gather_accumulate_cuda takes contiguous "
                         "tensors")
    out_h, out_w = canvas.shape[1:]
    out = torch.empty_like(canvas)
    if n == 0 or out_h * out_w == 0:
        return out
    lib = _load()
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.st_gather_accumulate(
            canvas.data_ptr(), glimpse.data_ptr(), zw.data_ptr(),
            z_pres.data_ptr(), out.data_ptr(), n, in_h, in_w, out_h, out_w,
            int(canvas.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"st_gather_accumulate kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    shape_launches["st_gather_accumulate", n, in_h, in_w, out_h, out_w] += 1
    return out


def st_gather_accumulate_plain(canvas: torch.Tensor, glimpse: torch.Tensor,
                               zw: torch.Tensor, z_pres: torch.Tensor,
                               paste=None) -> torch.Tensor:
    """The fused paste as the unfused ops: ``paste(glimpse, zw, (H, W))``,
    the presence mask, the f32 add, the cast back to the canvas's dtype.

    ``paste`` is ``st_gather_plain`` (looked up at the call) by default;
    ``STGather.apply`` makes these the ops that the fused kernel replaces,
    differentiable, with the paste kernel on the card.
    """
    paste = st_gather_plain if paste is None else paste
    acc = canvas.to(torch.float32) + z_pres[:, None, None] * paste(
        glimpse, zw, tuple(canvas.shape[-2:]))
    return acc.to(canvas.dtype)


class STGather(torch.autograd.Function):
    """``st_gather`` with its backward: ``(img (N,H,W), zw (N,4)) → (N,h,w)``,
    or with ``src (N,)`` the indexed gather of ``img (M,H,W)``.

    Saves ``(img, zw)`` (and ``src``) as the Pallas ``custom_vjp`` keeps
    its residuals.  CUDA tensors go to the kernels, CPU tensors to the
    plain versions, in f32 (the model runs the spatial transformer on f32
    operands).  The image gradient is computed only when autograd asks
    for it (the attend step's gather of the data image needs only
    ``g_zw``); an indexed gather raises if asked for it.
    """

    @staticmethod
    def forward(ctx, img, zw, out_shape, src=None):
        ctx.save_for_backward(img, zw, src)
        ctx.out_shape = tuple(out_shape)
        gather = st_gather_cuda if img.is_cuda else st_gather_plain
        # without src, the one-to-one call exactly as before
        return gather(img, zw, ctx.out_shape,
                      **({} if src is None else {"src": src}))

    @staticmethod
    def backward(ctx, g):
        img, zw, src = ctx.saved_tensors
        need_img, need_zw = ctx.needs_input_grad[:2]
        bwd = st_gather_bwd_cuda if g.is_cuda else st_gather_bwd_plain
        g_img, g_zw = bwd(img, zw, g.contiguous(), ctx.out_shape,
                          need_img=need_img,
                          **({} if src is None else {"src": src}))
        return g_img, (g_zw if need_zw else None), None, None


class STGatherAccumulate(torch.autograd.Function):
    """The fused paste with its backward:
    ``(canvas (N,H,W), glimpse (N,h,w), zw (N,4), z_pres (N,)) → (N,H,W)``.

    CUDA tensors go to ``st_gather_accumulate_cuda``, CPU tensors to
    ``st_gather_accumulate_plain``.  The backward is that of the unfused
    ops: the canvas's cotangent passes through (bf16 → f32 → bf16 is
    exact), and the paste's, ``z_pres · f32(g)``, goes to the gather's
    backward (kernel or plain), which gives the glimpse's and the window's
    gradients bit for bit as the unfused ops do.  ``z_pres`` is the
    presence sample, which takes no gradient.  Saves ``(glimpse, zw,
    z_pres)``, not the canvas.
    """

    @staticmethod
    def forward(ctx, canvas, glimpse, zw, z_pres):
        if ctx.needs_input_grad[3]:
            raise ValueError("STGatherAccumulate does not differentiate "
                             "z_pres")
        ctx.save_for_backward(glimpse, zw, z_pres)
        if canvas.is_cuda:
            return st_gather_accumulate_cuda(canvas, glimpse, zw, z_pres)
        return st_gather_accumulate_plain(canvas, glimpse, zw, z_pres)

    @staticmethod
    def backward(ctx, g):
        glimpse, zw, z_pres = ctx.saved_tensors
        need_canvas, need_glimpse, need_zw = ctx.needs_input_grad[:3]
        g_glimpse = g_zw = None
        if need_glimpse or need_zw:
            bwd = st_gather_bwd_cuda if g.is_cuda else st_gather_bwd_plain
            # bf16 * f32 is computed in f32: f32(g) * z_pres, one pass
            g_paste = (g * z_pres[:, None, None]).contiguous()
            g_glimpse, g_zw = bwd(glimpse, zw, g_paste, g.shape[-2:],
                                  need_img=need_glimpse)
        return (g if need_canvas else None, g_glimpse,
                g_zw if need_zw else None, None)
