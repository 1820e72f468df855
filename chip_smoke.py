"""Drive the PyTorch port of AIR serving on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the gather kernel (``csrc/st_gather.cu``) with nvcc;
3. kernel against plain: the kernel and its plain PyTorch version on the
   same inputs at the serving path's shapes (gather 50×50→20×20, paste
   20×20→50×50, synthesis paste 16×16→50×50), f32 and bf16 modes, edge
   cases; times of the kernel, the plain version and one PyTorch library
   call of the same function (``grid_sample``), beside the bound of the
   bytes and FLOP that this run's inputs need (``gather_work``);
4. the slice: canvas synthesis, serving requests through
   ``make_infer_fn`` for the ``serving`` preset and the ``canonical_fast``
   model, ``make_generate_fn``; launch counts read around that run; one
   request rerun through the plain spatial transformer and compared;
5. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Needs one card; stops no process it did not
start (it starts only ``nvidia-smi`` and ``nvcc``, and waits for both).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

N_SERVE = 8192
# Kernel against plain.  The kernel rounds as its plain version does (bit
# for bit at these shapes), so the bf16 limit sits well under one bf16 ulp
# of a pixel (~4e-3): a kernel that skipped a bf16 rounding would fail it.
F32_TOL, BF16_TOL = 1e-5, 1e-3

# Memory rate (bytes/s) and f32 CUDA-core peak (FLOP/s) of the H100 SXM
# (NVIDIA data sheet, dense, at the full power limit).
H100_SXM = "H100 80GB HBM3"
H100_SXM_PEAKS = (3.35e12, 67e12)


def card_peaks(name: str):
    if H100_SXM not in name:
        raise RuntimeError(f"no peak rates on record for {name!r}")
    return H100_SXM_PEAKS


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_where(n, gen, scale=(0.2, 1.2), shift=0.8):
    s = scale[0] + (scale[1] - scale[0]) * torch.rand(
        (n, 2), generator=gen, device="cuda")
    t = shift * (2 * torch.rand((n, 2), generator=gen, device="cuda") - 1)
    return torch.cat([s, t], dim=1).contiguous()


def grid_sample_gather(img, zw, out_shape):
    """The same function as one PyTorch library call (timed, never used by
    the port): ``grid_sample`` on the affine grid of ``(sx, sy, tx, ty)``."""
    import torch.nn.functional as F

    n = img.shape[0]
    theta = torch.zeros((n, 2, 3), device=img.device)
    theta[:, 0, 0], theta[:, 0, 2] = zw[:, 0], zw[:, 2]
    theta[:, 1, 1], theta[:, 1, 2] = zw[:, 1], zw[:, 3]
    grid = F.affine_grid(theta, (n, 1) + tuple(out_shape), align_corners=True)
    return F.grid_sample(img[:, None], grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)[:, 0]


def gather_work(zw, in_shape, out_shape):
    """Bytes and FLOP that this gather needs on these ``zw``.

    The kernel reads only the input pixels its nonzero taps touch: the
    rows of an example that some output row's taps reach, crossed with the
    columns that some output column's taps reach.  Bytes count the 32-byte
    sectors that hold those pixels, plus ``zw`` read and the output
    written once; FLOP count one multiply-add per nonzero tap pair.
    """
    from attend_infer_repeat_torch.ops.spatial_transformer import st_weights

    n = zw.shape[0]
    w_y, w_x = st_weights(zw, out_shape, in_shape)
    ny, nx = w_y != 0, w_x != 0                     # (N, h, H), (N, w, W)
    touched = ny.any(1)[:, :, None] & nx.any(1)[:, None, :]
    flat = touched.flatten()
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
    sectors = flat.view(-1, 8).any(1).sum().item()  # 8 floats per sector
    taps = (ny.sum((1, 2)).double() * nx.sum((1, 2)).double()).sum().item()
    nbytes = 32 * sectors + 4 * n * (4 + out_shape[0] * out_shape[1])
    return nbytes, 2 * taps, touched.sum().item() / touched.numel()


def kernel_phase(st_kernel, invert_where, bw, f32_peak):
    """Kernel against plain at the serving path's shapes; returns rows."""
    gen = torch.Generator("cuda").manual_seed(0)
    cases = [  # name, N, input, output, paste?
        ("gather 50x50->20x20", N_SERVE, (50, 50), (20, 20), False),
        ("gather 50x50->20x20", N_SERVE - 1, (50, 50), (20, 20), False),
        ("paste 20x20->50x50", N_SERVE, (20, 20), (50, 50), True),
        ("paste 20x20->50x50", N_SERVE - 1, (20, 20), (50, 50), True),
        ("synth paste 16x16->50x50", 2 * N_SERVE, (16, 16), (50, 50), True),
        ("generate paste 20x20->50x50", 3 * N_SERVE, (20, 20), (50, 50),
         True),
        ("gather 50x50->20x20", 1, (50, 50), (20, 20), False),
        ("gather 50x50->20x20", 5, (50, 50), (20, 20), False),
        ("paste 20x20->50x50", 17, (20, 20), (50, 50), True),
    ]
    rows = []
    for name, n, in_shape, out_shape, paste in cases:
        img = torch.rand((n,) + in_shape, generator=gen, device="cuda")
        zw = random_where(n, gen)
        if paste:
            zw = invert_where(zw).contiguous()
        errs = {}
        for mode, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            k = st_kernel.st_gather_cuda(img, zw, out_shape, mode)
            p = st_kernel.st_gather_plain(img, zw, out_shape, mode)
            torch.cuda.synchronize()
            errs[mode] = (k - p).abs().max().item()
            if not errs[mode] <= tol:
                raise AssertionError(f"{name} N={n} {mode}: kernel vs plain "
                                     f"max abs err {errs[mode]} > {tol}")
        row = {"case": name, "n": n, "max_abs_err": errs["float32"],
               "max_abs_err_bf16": errs["bfloat16"]}
        if n >= N_SERVE - 1:
            nbytes, flops, row["touched"] = gather_work(zw, in_shape,
                                                        out_shape)
            row.update(
                ms=cuda_ms(lambda: st_kernel.st_gather_cuda(
                    img, zw, out_shape)),
                plain_ms=cuda_ms(lambda: st_kernel.st_gather_plain(
                    img, zw, out_shape)),
                library_ms=cuda_ms(lambda: grid_sample_gather(
                    img, zw, out_shape)),
                bytes_ms=nbytes / bw * 1e3, ops_ms=flops / f32_peak * 1e3)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                               else "operations")
            print(f"  {name} N={n}: kernel {row['ms'] * 1e3:.2f} us, "
                  f"plain {row['plain_ms'] * 1e3:.2f} us, grid_sample "
                  f"{row['library_ms'] * 1e3:.2f} us, bound "
                  f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}; "
                  f"{nbytes / 1e6:.2f} MB, input touched "
                  f"{100 * row['touched']:.1f}%); err f32 {errs['float32']:.3g} bf16 "
                  f"{errs['bfloat16']:.3g}", flush=True)
        else:
            print(f"  {name} N={n}: err f32 {errs['float32']:.3g} bf16 "
                  f"{errs['bfloat16']:.3g}", flush=True)
        rows.append(row)

    # every sample out of bounds: exactly zero
    img = torch.ones((64, 20, 20), device="cuda")
    zw = torch.tensor([[0.5, 0.5, 5.0, 5.0], [0.5, 0.5, -5.0, -5.0]],
                      device="cuda").repeat(32, 1)
    out = st_kernel.st_gather_cuda(img, zw, (8, 8))
    if out.abs().max().item() != 0.0:
        raise AssertionError("out-of-bounds gather is not exactly 0")
    # near-zero scales: the eps-guarded inverse is huge; the paste is 0
    g = torch.rand((64, 20, 20), generator=gen, device="cuda")
    zw = torch.tensor([[0.0, 0.0, 0.01, 0.01], [1e-9, -1e-9, 0.0, 0.0]],
                      device="cuda").repeat(32, 1)
    out = st_kernel.st_gather_cuda(g, invert_where(zw).contiguous(), (50, 50))
    if not (torch.isfinite(out).all().item() and out.abs().max().item() == 0):
        raise AssertionError("near-zero-scale paste is not finite and 0")
    print("  out-of-bounds gather and near-zero-scale paste: exactly 0",
          flush=True)
    return rows


def timed(fn, *args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def check_infer(out, batch, cfg):
    t = cfg.max_steps
    h, w = cfg.img_size
    d_where = 3 if cfg.isotropic_scale else 4
    shapes = {"canvas": (batch, h, w), "elbo": (batch,),
              "z_where": (batch, t, 4), "where_loc": (batch, t, d_where),
              "where_scale": (batch, t, d_where),
              "what_loc": (batch, t, cfg.n_what),
              "what_scale": (batch, t, cfg.n_what),
              "presence": (batch, t), "presence_prob": (batch, t),
              "num_steps_pmf": (batch, t + 1), "predicted_steps": (batch,),
              "mode_steps": (batch,)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        if not torch.isfinite(out[k]).all().item():
            raise AssertionError(f"{k}: not finite")
    for k in ("predicted_steps", "mode_steps"):
        if not ((out[k] >= 0).all() and (out[k] <= t).all()).item():
            raise AssertionError(f"{k}: count outside [0, {t}]")


def slice_phase(air, st_kernel, smi):
    """The serving path, end to end; returns the kernel launches it made."""
    from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
    from attend_infer_repeat_torch.serving import (
        make_generate_fn, make_infer_fn)

    cfg = air.get_config("serving")
    fast = air.get_config("canonical_fast")
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
    synth = make_synth_fn(cfg.data, bank)
    model = air.AIRModel(cfg.model, use_baseline=False, seed=0)
    model_fast = air.AIRModel(fast.model, use_baseline=False, seed=1)
    infer = make_infer_fn(cfg, model)
    infer_tiled = make_infer_fn(cfg, model, tile=N_SERVE)
    infer_fast = make_infer_fn(fast, model_fast)
    generate = make_generate_fn(cfg, model)
    gen = torch.Generator("cuda").manual_seed(0)
    per_forward = 2 * cfg.model.max_steps   # one gather + one paste a step

    st_kernel.launches = 0
    expected = 0

    def expect(delta, what):
        nonlocal expected
        expected += delta
        if st_kernel.launches != expected:
            raise AssertionError(f"{what}: {st_kernel.launches} launches, "
                                 f"expected {expected}")

    (imgs, nums), dt = timed(synth, N_SERVE, gen)
    expect(1, "synthesis")
    if not (imgs.shape == (N_SERVE, 50, 50) and torch.isfinite(imgs).all()
            and imgs.min() >= 0 and imgs.max() <= 1):
        raise AssertionError("synthesized canvases out of range")
    print(f"  synthesized {N_SERVE} canvases in {dt * 1e3:.1f} ms "
          f"(mean count {nums.float().mean().item():.3f})", flush=True)

    rates = []
    for r in range(4):
        out, dt = timed(infer, imgs, gen)
        expect(per_forward, f"serving request {r}")
        check_infer(out, N_SERVE, cfg.model)
        rates.append(N_SERVE / dt)
        print(f"  serving request {r}: {dt * 1e3:.2f} ms, "
              f"{N_SERVE / dt:.1f} img/s", flush=True)
    wide = torch.cat([imgs, torch.flip(imgs, dims=[2])], 0)
    out, dt = timed(infer_tiled, wide, gen)
    expect(2 * per_forward, "tiled request of 16384")
    check_infer(out, 2 * N_SERVE, cfg.model)
    print(f"  tiled request of {2 * N_SERVE} (tile {N_SERVE}): "
          f"{dt * 1e3:.2f} ms", flush=True)
    fast_rates = []
    for r in range(2):
        out, dt = timed(infer_fast, imgs, gen)
        expect(per_forward, f"canonical_fast request {r}")
        check_infer(out, N_SERVE, fast.model)
        fast_rates.append(N_SERVE / dt)
        print(f"  canonical_fast request {r}: {dt * 1e3:.2f} ms, "
              f"{N_SERVE / dt:.1f} img/s", flush=True)
    gen_rates = []
    for r in range(2):
        scenes, dt = timed(generate, N_SERVE, gen)
        expect(1, f"generate {r}")
        if not (scenes.shape == (N_SERVE, 50, 50)
                and torch.isfinite(scenes).all() and scenes.min() >= 0
                and scenes.max() <= cfg.model.max_steps):
            raise AssertionError("generated scenes out of range")
        gen_rates.append(N_SERVE / dt)
        print(f"  generate {r}: {dt * 1e3:.2f} ms, {N_SERVE / dt:.1f} img/s",
              flush=True)
    launches = st_kernel.launches
    print(f"  main path: {launches} kernel launches "
          f"({per_forward} per forward of one tile)", flush=True)
    print(f"  infer img/s at batch {N_SERVE} (serving, requests 1-3 median): "
          f"{statistics.median(rates[1:]):.1f} on {smi}", flush=True)
    print(f"  infer img/s at batch {N_SERVE} (canonical_fast, request 1): "
          f"{fast_rates[1]:.1f} on {smi}", flush=True)
    print(f"  generate img/s at batch {N_SERVE} (call 1): "
          f"{gen_rates[1]:.1f} on {smi}", flush=True)

    # the same request through the plain spatial transformer on the card
    noise = model.sample_noise(N_SERVE, gen)
    out_k, dt_k = timed(infer, imgs, noise=noise)
    kernel_fn = st_kernel.st_gather_cuda
    st_kernel.st_gather_cuda = st_kernel.st_gather_plain
    try:
        infer(imgs, noise=noise)
        out_p, dt_p = timed(infer, imgs, noise=noise)
    finally:
        st_kernel.st_gather_cuda = kernel_fn
    canvas_err = (out_k["canvas"] - out_p["canvas"]).abs().max().item()
    elbo_rel = ((out_k["elbo"] - out_p["elbo"]).abs()
                / out_p["elbo"].abs().clamp(min=1.0)).max().item()
    pres_equal = torch.equal(out_k["presence"], out_p["presence"])
    print(f"  kernel vs plain ST on one request: canvas max abs err "
          f"{canvas_err:.3g}, elbo max rel err {elbo_rel:.3g}, presence "
          f"{'equal' if pres_equal else 'DIFFERS'}; request "
          f"{dt_k * 1e3:.2f} ms with the kernel, {dt_p * 1e3:.2f} ms plain",
          flush=True)
    if not (canvas_err <= 1e-4 and elbo_rel <= 1e-5 and pres_equal):
        raise AssertionError("the slice through the kernel disagrees with "
                             "the plain spatial transformer")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import attend_infer_repeat_torch as air
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.ops.spatial_transformer import invert_where

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    print("[1] device", flush=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    bw, f32_peak = card_peaks(kind)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{kind}: {bw / 1e12} TB/s, {f32_peak / 1e12} TFLOP/s f32 "
          f"(data sheet)", flush=True)

    print("[2] build", flush=True)
    t = time.perf_counter()
    lib = st_kernel.build()
    print(f"  built {lib.name} in {time.perf_counter() - t:.2f} s", flush=True)
    print("  " + lib.with_suffix(".log").read_text().strip()
          .replace("\n", "\n  "), flush=True)

    print(f"[3] kernel against plain (max abs err limits: f32 {F32_TOL}, "
          f"bf16 {BF16_TOL})", flush=True)
    rows = kernel_phase(st_kernel, invert_where, bw, f32_peak)

    print("[4] the slice", flush=True)
    launches = slice_phase(air, st_kernel, smi)

    timed_rows = [r for r in rows if "ms" in r]
    head = timed_rows[0]                       # gather 50x50->20x20, N=8192
    kernel = {
        "name": "st_gather", "route": "cuda",
        "source": "attend_infer_repeat_torch/csrc/st_gather.cu",
        "replaces": "attend_infer_repeat_tpu/ops/pallas_st.py:54",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_abs_err_bf16": max(r["max_abs_err_bf16"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"{head['case']} N={head['n']}",
        "shapes": [{k: r[k] for k in ("case", "n", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "max_abs_err")} for r in timed_rows],
    }
    print(f"  total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
