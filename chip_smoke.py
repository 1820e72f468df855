"""Drive the PyTorch port of AIR (serving and training) on one NVIDIA GPU
and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the gather kernel and its backward (``csrc/``) with one
   nvcc call;
3. kernel against plain: the gather kernel and its plain PyTorch version
   on the same inputs at the serving and train paths' shapes (gather
   50×50→20×20, paste 20×20→50×50, synthesis paste 16×16→50×50), f32 and
   bf16 modes, edge cases, and the windows of ``WINDOW_CASES`` (each
   names the kernel branch it reaches); times of the kernel, the plain
   version and one PyTorch library call of the same function
   (``grid_sample``), beside the bound of the bytes and FLOP that this
   run's inputs need (``gather_work``);
3b. the backward kernel against its plain version in the same way, at
   the train step's shapes and at N = 8192, ragged N and an odd shape;
   edge cases and ``WINDOW_CASES``; two runs bit-identical; the library
   call is ``grid_sample``'s backward; the bound counts the cotangent only
   where it has a tap (``gather_bwd_work``);
4. the serving slice: canvas synthesis, serving requests through
   ``make_infer_fn`` for the ``serving`` preset and the ``canonical_fast``
   model, ``make_generate_fn``; launch counts read around that run; one
   request rerun through the plain spatial transformer and compared;
5. the train step: ``canonical_fast`` at batch 1024 through
   ``create_train_state`` and ``make_train_step`` (warm-up, then timed
   steps), then one ``make_eval_step``; launch counts read around that
   run (per step: 1 synthesis paste, 6 forward, 6 backward launches; the
   preset's remat ``save_st`` recomputes no kernel);
5b. one more step with every kernel call's inputs recorded; each kernel
   against plain and timed on the windows, images and cotangents that the
   step really gives it (after the counts were read);
5c. the K-step chunk as a replayed CUDA graph (``make_scan_train_step``):
   for K = 4 and the preset's 100, the graphed chunk and the same K steps
   run eagerly (``utils.debug_mode``) from one state must agree bit for
   bit in parameters, optimizer state and every metric row (else the
   largest gap is printed and held to phase 6's ``canonical_fast``
   limits); launch counts read around that run (a replay counts the
   launches of one captured step); then step wall and train img/s,
   eager and graphed, with the preset's remat ``save_st`` and with remat
   off;
6. one step's loss and gradients through the kernels and through the
   plain spatial transformer, for ``canonical`` and ``canonical_fast``;
7. the training loop: ``train()`` on ``canonical_fast`` at batch 1024 to
   200 steps (K-step chunks of 100 through the graph, log/eval/save/
   figure points every 100, the basin detector at 100), launch counts
   read around that run; the same run as 100 steps and a resume to 200,
   whose parameters and optimizer state must equal the uninterrupted
   run's bit for bit; the JSONL rows, the best checkpoint and finite
   metrics; then the CLI (``python -m attend_infer_repeat_torch.train``)
   for 2 steps;
7b. data parallelism on a one-rank NCCL mesh (``parallel.make_mesh``):
   the mesh step and the external-batch shard-map step against the plain
   step from the same state, and a per-rank shard-map step;
7c. ``utils.trace`` around a graphed chunk writes a trace that holds the
   replayed kernels, and ``utils.debug_mode`` traps a NaN injected into
   a train step's batch;
8. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Phases 3 and 3b include the ``crowded`` preset's 100×100 canvas.  The
``kernels`` line counts every launch of the main paths (phases 4, 5, 5c,
7 and 7b): eager launches, and for a replayed graph the launches of one
captured step times its replays.  Imports nothing of JAX.  Needs one card; stops no process it did not start (it
starts ``nvidia-smi``, ``nvcc`` and the CLI run, and waits for each).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

N_SERVE = 8192
N_TRAIN = 1024          # the canonical_fast (and crowded) train step's batch
LOOP_STEPS = 200        # phase 7: train() to this step, resumed at half
SLEEP_CYCLES = 50_000_000   # ~30 ms at the H100's ~1.7 GHz
# Kernel against plain.  The kernel rounds as its plain version does (bit
# for bit at these shapes), so the bf16 limit sits well under one bf16 ulp
# of a pixel (~4e-3): a kernel that skipped a bf16 rounding would fail it.
F32_TOL, BF16_TOL = 1e-5, 1e-3
# Backward kernel against plain: g_img and g_zw max abs err over
# max(1, max|plain|).  Each g_zw sums up to 2500·4 products with
# cancellation, in another order than the plain matmuls.  The kernel rounds
# where its plain version rounds, so the bf16 mode is held to the same
# limits: one skipped bf16 rounding (~4e-3 relative per term) fails them.
BWD_TOL = (1e-5, 1e-4)
# One step through the kernels against the plain ST: (loss rel err,
# largest per-tensor gradient rel L2 err).  canonical is f32 end to end;
# in canonical_fast the forward kernel is bit-equal to plain, and an f32
# ulp of backward difference entering the bf16 matmuls' backward can flip
# a bf16 rounding.  The gradient limits were 1e-4 and 1e-2; measured on an
# H100 3.78e-7 and 2.66e-4, so they are tightened to about twice that.
STEP_LIMITS = {"canonical": (1e-6, 1e-6), "canonical_fast": (0.0, 5e-4)}

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
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).

    The stream first runs a sleep kernel of ~30 ms, long enough for the
    host to queue every launch before the first one starts, so the events
    time the device running them back to back, not the host's launch rate
    (at N = 1024 a call's host side takes longer than its kernel).
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
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


# Windows that reach each branch of the two kernels: kind -> the branch.
WINDOW_CASES = {
    "step-like windows": "scale 0.1-0.45 as the train step's: short live "
                         "intervals, the forward's zero rows",
    "one live row and column": "the live interval is one row and one "
                               "column (the next one's p is below -1)",
    "windows on each edge": "live intervals that end at a canvas edge, "
                            "taps at q0 = -1 and q0 + 1 = in",
    "negative scales": "p decreasing in the output index",
    "dead beside live": "examples with no live tap beside live ones in "
                        "one launch",
    "tiny scales at an edge": "p within a few ulps of -1 across the rows: "
                              "rounding decides the live interval",
}


def branch_where(kind, n, in_shape, out_shape, paste, gen, invert_where):
    """``zw (n, 4)`` for one of ``WINDOW_CASES``, on ``gen``'s device.

    Windows are drawn as the model draws them and inverted for a paste,
    except two kinds that place the kernel's own coordinates: "one live
    row and column" (the last output row and column sample p in
    (-0.9, 0.99), their neighbours p - 2) and "tiny scales at an edge"
    (every row samples p within ~1e-5 of -1: row scale ±1e-7 to 3e-7)."""
    dev = gen.device

    def rand(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    if kind == "one live row and column":
        zw = torch.empty((n, 4), device=dev)
        for axis, (n_in, n_out) in enumerate(zip(in_shape[::-1],
                                                 out_shape[::-1])):
            s = 2.0 * (n_out - 1) / max(n_in - 1, 1)   # 2 pixels apart
            zw[:, axis] = s
            zw[:, 2 + axis] = 2 * rand(-0.9, 0.99, n) / (n_in - 1) - 1 - s
        return zw
    if kind == "tiny scales at an edge":
        sign = torch.where(rand(0, 1, n) < 0.5, -1.0, 1.0)
        return torch.stack([rand(0.2, 1.2, n), sign * rand(1e-7, 3e-7, n),
                            rand(-0.5, 0.5, n),
                            -2.0 / (in_shape[0] - 1) - 1
                            + 1e-7 * torch.randn(n, generator=gen,
                                                 device=dev)], 1)
    s, t = rand(0.1, 0.45, n, 2), rand(-0.8, 0.8, n, 2)
    if kind == "windows on each edge":
        side = torch.arange(n, device=dev) % 4      # right, left, bottom, top
        axis, sign = side // 2, 1.0 - 2.0 * (side % 2)
        t[torch.arange(n, device=dev), axis] = sign
    elif kind == "negative scales":
        s = rand(-1.2, -0.1, n, 2)
    elif kind == "dead beside live":
        s = rand(0.2, 1.2, n, 2)
        t[::2] = 5.0
    zw = torch.cat([s, t], dim=1).contiguous()
    return invert_where(zw).contiguous() if paste else zw


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


def sectors(mask) -> int:
    """32-byte sectors (8 floats) of a contiguous float32 tensor shaped as
    ``mask`` that hold at least one pixel where ``mask`` is set."""
    flat = mask.flatten()
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
    return flat.view(-1, 8).any(1).sum().item()


def tap_support(zw, in_shape, out_shape):
    """The gather's nonzero taps on these ``zw``: the input pixels they
    touch (rows that some output row's taps reach, crossed with columns
    that some output column's taps reach), the output pixels that have a
    tap (a row with a nonzero tap crossed with such a column), and the
    number of nonzero tap pairs."""
    from attend_infer_repeat_torch.ops.spatial_transformer import st_weights

    w_y, w_x = st_weights(zw, out_shape, in_shape)
    ny, nx = w_y != 0, w_x != 0                     # (N, h, H), (N, w, W)
    touched_in = ny.any(1)[:, :, None] & nx.any(1)[:, None, :]
    touched_out = ny.any(2)[:, :, None] & nx.any(2)[:, None, :]
    taps = (ny.sum((1, 2)).double() * nx.sum((1, 2)).double()).sum().item()
    return touched_in, touched_out, taps


def gather_work(zw, in_shape, out_shape):
    """Bytes and FLOP that this gather needs on these ``zw``.

    The kernel reads only the input pixels its nonzero taps touch.  Bytes
    count the 32-byte sectors that hold those pixels, plus ``zw`` read and
    the output written once; FLOP count one multiply-add per nonzero tap
    pair.  Also returns the touched share of the input.
    """
    touched, _, taps = tap_support(zw, in_shape, out_shape)
    n = zw.shape[0]
    nbytes = 32 * sectors(touched) + 4 * n * (4 + out_shape[0] * out_shape[1])
    return nbytes, 2 * taps, touched.sum().item() / touched.numel()


def timing(kernel, plain, library, nbytes, flops, bw, f32_peak):
    """Device ms of the kernel, its plain version and the library call,
    and the bound: ``nbytes`` and ``flops`` at the card's peak rates."""
    row = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
               library_ms=cuda_ms(library), bytes_ms=nbytes / bw * 1e3,
               ops_ms=flops / f32_peak * 1e3)
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                       else "operations")
    return row


def timing_text(row, nbytes, library):
    return (f"kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, {library} "
            f"{row['library_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}; "
            f"{nbytes / 1e6:.3f} MB)")


def check_gather(st_kernel, row, img, zw, out_shape):
    """The forward kernel against plain in both modes; errors into
    ``row``, raises on a miss.  Returns the message."""
    for mode, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        k = st_kernel.st_gather_cuda(img, zw, out_shape, mode)
        p = st_kernel.st_gather_plain(img, zw, out_shape, mode)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{row['case']} N={row['n']} {mode}: kernel "
                                 f"vs plain max abs err {err} > {tol}")
        row["max_abs_err" + ("" if mode == "float32" else "_bf16")] = err
    return (f"  {row['case']} N={row['n']}: err f32 {row['max_abs_err']:.3g}"
            f" bf16 {row['max_abs_err_bf16']:.3g}")


def time_gather(st_kernel, row, img, zw, out_shape, bw, f32_peak):
    """Time the forward kernel on these inputs into ``row``; its text."""
    in_shape = tuple(img.shape[1:])
    nbytes, flops, row["touched"] = gather_work(zw, in_shape, out_shape)
    row.update(timing(
        lambda: st_kernel.st_gather_cuda(img, zw, out_shape),
        lambda: st_kernel.st_gather_plain(img, zw, out_shape),
        lambda: grid_sample_gather(img, zw, out_shape),
        nbytes, flops, bw, f32_peak))
    return (timing_text(row, nbytes, "grid_sample")
            + f", input touched {100 * row['touched']:.1f}%")


def kernel_phase(st_kernel, invert_where, bw, f32_peak):
    """Kernel against plain at the serving path's shapes; returns rows."""
    gen = torch.Generator("cuda").manual_seed(0)
    cases = [  # name, N, input, output, paste?, timed?
        ("gather 50x50->20x20", N_SERVE, (50, 50), (20, 20), False, True),
        ("gather 50x50->20x20", N_SERVE - 1, (50, 50), (20, 20), False, True),
        ("paste 20x20->50x50", N_SERVE, (20, 20), (50, 50), True, True),
        ("paste 20x20->50x50", N_SERVE - 1, (20, 20), (50, 50), True, True),
        ("synth paste 16x16->50x50", 2 * N_SERVE, (16, 16), (50, 50), True,
         True),
        ("generate paste 20x20->50x50", 3 * N_SERVE, (20, 20), (50, 50),
         True, True),
        # the train step's shapes (canonical_fast, batch 1024)
        ("gather 50x50->20x20", N_TRAIN, (50, 50), (20, 20), False, True),
        ("paste 20x20->50x50", N_TRAIN, (20, 20), (50, 50), True, True),
        ("synth paste 16x16->50x50", 2 * N_TRAIN, (16, 16), (50, 50), True,
         True),
        # crowded: 100x100 canvas, 5 steps, 0-5 digits, batch 1024
        ("gather 100x100->20x20", N_TRAIN, (100, 100), (20, 20), False, True),
        ("paste 20x20->100x100", N_TRAIN, (20, 20), (100, 100), True, True),
        ("synth paste 16x16->100x100", 5 * N_TRAIN, (16, 16), (100, 100),
         True, True),
        ("gather 50x50->20x20", 1, (50, 50), (20, 20), False, False),
        ("gather 50x50->20x20", 5, (50, 50), (20, 20), False, False),
        ("paste 20x20->50x50", 17, (20, 20), (50, 50), True, False),
    ]
    rows = []
    for name, n, in_shape, out_shape, paste, timed_case in cases:
        img = torch.rand((n,) + in_shape, generator=gen, device="cuda")
        zw = random_where(n, gen)
        if paste:
            zw = invert_where(zw).contiguous()
        row = {"case": name, "n": n}
        msg = check_gather(st_kernel, row, img, zw, out_shape)
        if timed_case:
            msg += "; " + time_gather(st_kernel, row, img, zw, out_shape, bw,
                                      f32_peak)
        print(msg, flush=True)
        rows.append(row)
    rows += branch_phase(
        st_kernel, invert_where, gen,
        [("gather 50x50->20x20", (50, 50), (20, 20), False),
         ("paste 20x20->50x50", (20, 20), (50, 50), True),
         ("synth paste 16x16->50x50", (16, 16), (50, 50), True),
         ("gather 100x100->20x20", (100, 100), (20, 20), False),
         ("paste 20x20->100x100", (20, 20), (100, 100), True)],
        backward=False)

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


def branch_phase(st_kernel, invert_where, gen, shapes, backward):
    """Each of ``WINDOW_CASES`` at each shape, at the ragged N = 1023: the
    forward (or, with ``backward``, the backward with g_img) against plain
    in both modes; returns the rows."""
    rows = []
    for kind, branch in WINDOW_CASES.items():
        for name, in_shape, out_shape, paste in shapes:
            n = N_TRAIN - 1
            img = torch.rand((n,) + in_shape, generator=gen, device="cuda")
            zw = branch_where(kind, n, in_shape, out_shape, paste, gen,
                              invert_where)
            row = {"case": f"{name}, {kind}", "n": n}
            if backward:
                g = torch.randn((n,) + out_shape, generator=gen,
                                device="cuda")
                msg = check_bwd(st_kernel, row, img, zw, g, out_shape, True)
            else:
                msg = check_gather(st_kernel, row, img, zw, out_shape)
            print(f"{msg} [{branch}]", flush=True)
            rows.append(row)
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

    st_kernel.launches = st_kernel.bwd_launches = 0
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
    if st_kernel.bwd_launches:
        raise AssertionError("serving launched the backward kernel")
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

def gather_bwd_work(zw, in_shape, out_shape, need_img):
    """Bytes and FLOP that this gather's backward needs on these ``zw``.

    Reads, by 32-byte sector: the input pixels the forward's taps touch,
    and the cotangent ``g`` at the output pixels that have a tap (at any
    other pixel the hat weights and their dW/dp, which share a support,
    are 0, so neither gradient depends on ``g`` there); ``zw`` read and
    ``g_zw`` written; ``g_img`` written whole when asked for.  FLOP: per
    nonzero tap pair, the two zw sums take two multiply-adds each and
    ``g_img`` two more.  Also returns the touched shares of the input and
    of ``g``.
    """
    touched_in, touched_out, taps = tap_support(zw, in_shape, out_shape)
    n = zw.shape[0]
    nbytes = (32 * (sectors(touched_in) + sectors(touched_out)) + 32 * n
              + (4 * n * in_shape[0] * in_shape[1] if need_img else 0))
    return (nbytes, 2 * taps * (6 if need_img else 4),
            touched_in.sum().item() / touched_in.numel(),
            touched_out.sum().item() / touched_out.numel())


def grid_sample_backward(img, zw, out_shape, g, need_img):
    """``fn()`` that runs the backward of ``grid_sample_gather`` as one
    PyTorch library call (timed, never used by the port): the gradient of
    ``grid_sample`` on the affine grid w.r.t. ``theta`` (and the image)."""
    import torch.nn.functional as F

    n = img.shape[0]
    theta = torch.zeros((n, 2, 3), device=img.device)
    theta[:, 0, 0], theta[:, 0, 2] = zw[:, 0], zw[:, 2]
    theta[:, 1, 1], theta[:, 1, 2] = zw[:, 1], zw[:, 3]
    theta.requires_grad_()
    x = img[:, None].detach().requires_grad_(need_img)
    grid = F.affine_grid(theta, (n, 1) + tuple(out_shape), align_corners=True)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)[:, 0]
    wrt = (x, theta) if need_img else (theta,)
    return lambda: torch.autograd.grad(out, wrt, g, retain_graph=True)


def bwd_errors(k, p):
    """``(g_img err, g_zw err, within limits?)``: abs errors, and the
    limit check of each output against the scale of its plain version."""
    errs, ok = [], True
    for a, b, rel in zip(k, p, BWD_TOL):
        if b is None:
            errs.append(0.0)
            continue
        errs.append((a - b).abs().max().item())
        ok &= errs[-1] <= rel * max(1.0, b.abs().max().item())
    return errs[0], errs[1], ok


def check_bwd(st_kernel, row, img, zw, g, out_shape, need_img):
    """The backward kernel against plain in both modes, and run twice;
    errors into ``row``, raises on a miss.  Returns the message."""
    name = f"{row['case']} N={row['n']}"
    for mode in ("float32", "bfloat16"):
        k = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode,
                                         need_img)
        p = st_kernel.st_gather_bwd_plain(img, zw, g, out_shape, mode,
                                          need_img)
        again = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape, mode,
                                             need_img)
        torch.cuda.synchronize()
        e_img, e_zw, ok = bwd_errors(k, p)
        if not ok:
            raise AssertionError(f"{name} {mode}: backward kernel vs plain "
                                 f"err g_img {e_img} g_zw {e_zw} over the "
                                 f"limit")
        if not all(a is b or torch.equal(a, b) for a, b in zip(k, again)):
            raise AssertionError(f"{name} {mode}: two runs of the backward "
                                 f"kernel differ")
        tag = "" if mode == "float32" else "_bf16"
        row["max_abs_err" + tag] = max(e_img, e_zw)
        row["err_g_img" + tag], row["err_g_zw" + tag] = e_img, e_zw
    return (f"  {name}: err f32 g_img {row['err_g_img']:.3g} g_zw "
            f"{row['err_g_zw']:.3g}, bf16 g_img {row['err_g_img_bf16']:.3g} "
            f"g_zw {row['err_g_zw_bf16']:.3g}; deterministic")


def time_gather_bwd(st_kernel, row, img, zw, g, out_shape, need_img, bw,
                    f32_peak):
    """Time the backward kernel on these inputs into ``row``; its text."""
    in_shape = tuple(img.shape[1:])
    nbytes, flops, row["touched"], row["g_touched"] = gather_bwd_work(
        zw, in_shape, out_shape, need_img)
    row.update(timing(
        lambda: st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape,
                                             need_img=need_img),
        lambda: st_kernel.st_gather_bwd_plain(img, zw, g, out_shape,
                                              need_img=need_img),
        grid_sample_backward(img, zw, out_shape, g, need_img),
        nbytes, flops, bw, f32_peak))
    return (timing_text(row, nbytes, "grid_sample backward")
            + f", input touched {100 * row['touched']:.1f}%, g touched "
            f"{100 * row['g_touched']:.1f}%")


def bwd_phase(st_kernel, invert_where, bw, f32_peak):
    """The backward kernel against plain at the train step's shapes."""
    gen = torch.Generator("cuda").manual_seed(1)
    cases = [  # name, N, input, output, paste?, g_img?, timed?
        ("gather bwd 50x50->20x20, g_zw only (as the step)", N_TRAIN,
         (50, 50), (20, 20), False, False, True),
        ("gather bwd 50x50->20x20", N_TRAIN, (50, 50), (20, 20), False, True,
         True),
        ("paste bwd 20x20->50x50", N_TRAIN, (20, 20), (50, 50), True, True,
         True),
        ("gather bwd 50x50->20x20, g_zw only (as the step)", N_SERVE,
         (50, 50), (20, 20), False, False, True),
        ("gather bwd 50x50->20x20", N_SERVE, (50, 50), (20, 20), False, True,
         True),
        ("paste bwd 20x20->50x50", N_SERVE, (20, 20), (50, 50), True, True,
         True),
        # crowded's shapes: both take the > 48 KB shared-memory opt-in
        ("gather bwd 100x100->20x20, g_zw only (as the step)", N_TRAIN,
         (100, 100), (20, 20), False, False, True),
        ("gather bwd 100x100->20x20", N_TRAIN, (100, 100), (20, 20), False,
         True, True),
        ("paste bwd 20x20->100x100", N_TRAIN, (20, 20), (100, 100), True,
         True, True),
        ("gather bwd 50x50->20x20", 1, (50, 50), (20, 20), False, True,
         False),
        ("gather bwd 50x50->20x20", 5, (50, 50), (20, 20), False, True,
         False),
        ("paste bwd 20x20->50x50", 17, (20, 20), (50, 50), True, True,
         False),
        ("paste bwd 20x20->50x50", N_TRAIN - 1, (20, 20), (50, 50), True,
         True, False),
        ("gather bwd 25x31->9x13", 7, (25, 31), (9, 13), False, True, False),
    ]
    rows = []
    for name, n, in_shape, out_shape, paste, need_img, timed_case in cases:
        img = torch.rand((n,) + in_shape, generator=gen, device="cuda")
        zw = random_where(n, gen)
        if paste:
            zw = invert_where(zw).contiguous()
        g = torch.randn((n,) + out_shape, generator=gen, device="cuda")
        row = {"case": name, "n": n}
        msg = check_bwd(st_kernel, row, img, zw, g, out_shape, need_img)
        if timed_case:
            msg += "; " + time_gather_bwd(st_kernel, row, img, zw, g,
                                          out_shape, need_img, bw, f32_peak)
        print(msg, flush=True)
        rows.append(row)
    rows += branch_phase(
        st_kernel, invert_where, gen,
        [("gather bwd 50x50->20x20", (50, 50), (20, 20), False),
         ("paste bwd 20x20->50x50", (20, 20), (50, 50), True),
         ("gather bwd 100x100->20x20", (100, 100), (20, 20), False),
         ("paste bwd 20x20->100x100", (20, 20), (100, 100), True)],
        backward=True)

    # every sample out of range, and near-zero-scale pastes: exactly zero
    img = torch.rand((64, 20, 20), generator=gen, device="cuda")
    zw = torch.tensor([[0.5, 0.5, 5.0, 5.0], [0.5, 0.5, -5.0, -5.0]],
                      device="cuda").repeat(32, 1)
    out = st_kernel.st_gather_bwd_cuda(
        img, zw, torch.randn((64, 8, 8), generator=gen, device="cuda"),
        (8, 8))
    inv = invert_where(torch.tensor(
        [[0.0, 0.0, 0.01, 0.01], [1e-9, -1e-9, 0.0, 0.0]],
        device="cuda").repeat(32, 1)).contiguous()
    out += st_kernel.st_gather_bwd_cuda(
        img, inv, torch.randn((64, 50, 50), generator=gen, device="cuda"),
        (50, 50))
    if not all(t.abs().max().item() == 0.0 for t in out):
        raise AssertionError("out-of-range backward is not exactly 0")
    print("  out-of-range windows and near-zero-scale pastes: both "
          "gradients exactly 0", flush=True)
    return rows


def check_metrics(metrics, what):
    bad = [k for k, v in metrics.items()
           if not torch.isfinite(v).all().item()]
    if bad:
        raise AssertionError(f"{what}: metrics not finite: {bad}")


def train_phase(air, st_kernel, smi, bank):
    """canonical_fast train steps at batch 1024, then one eval step;
    returns the forward and backward kernel launches of that run."""
    from attend_infer_repeat_torch.data import make_synth_fn

    fast = air.get_config("canonical_fast")
    state = air.create_train_state(fast, seed=0)
    step = air.make_train_step(fast, state.model, digit_bank=bank)
    synth = make_synth_fn(fast.data, bank)
    eval_step = air.make_eval_step(fast, state.model)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    n_cells = fast.model.max_steps
    per_step = (1 + 2 * n_cells, 2 * n_cells)     # synthesis + gather/paste
    warm, timed_steps = 3, 20

    st_kernel.launches = st_kernel.bwd_launches = 0
    for i in range(warm):
        state, m = step(state)
        counts = (st_kernel.launches, st_kernel.bwd_launches)
        if counts != ((i + 1) * per_step[0], (i + 1) * per_step[1]):
            raise AssertionError(f"train step {i}: launches {counts}, "
                                 f"expected {per_step} per step")
        check_metrics(m, f"train step {i}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    rows = []
    for _ in range(timed_steps):
        state, m = step(state)
        rows.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / timed_steps
    for i, m in enumerate(rows):
        check_metrics(m, f"train step {warm + i}")
    n_steps = warm + timed_steps
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    if counts != (n_steps * per_step[0], n_steps * per_step[1]):
        raise AssertionError(f"{n_steps} train steps: launches {counts}")
    moved = max((v - start[k]).abs().max().item()
                for k, v in state.model.state_dict().items())
    if not (moved > 0 and state.step == n_steps):
        raise AssertionError("the train steps changed no parameter")
    last = rows[-1]
    print(f"  {n_steps} train steps (canonical_fast, batch {N_TRAIN}): "
          f"{per_step[0]} forward and {per_step[1]} backward launches per "
          f"step; last loss {last['loss'].item():.1f}, elbo "
          f"{last['elbo'].item():.2f}, grad_norm "
          f"{last['grad_norm'].item():.1f}; parameters moved up to "
          f"{moved:.3g}", flush=True)
    print(f"  train step {dt * 1e3:.3f} ms (mean of {timed_steps} after "
          f"{warm} warm-up), {N_TRAIN / dt:.1f} train img/s at batch "
          f"{N_TRAIN} on {smi}", flush=True)

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = torch.Generator("cuda").manual_seed(2)
    imgs, nums = synth(N_TRAIN, gen)
    metrics, out = eval_step(state, imgs, nums, gen)
    check_metrics(metrics, "eval step")
    if not all(torch.equal(v, before[k])
               for k, v in state.model.state_dict().items()):
        raise AssertionError("the eval step changed a parameter")
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    if counts != (n_steps * per_step[0] + 1 + 2 * n_cells,
                  n_steps * per_step[1]):
        raise AssertionError(f"eval step: launches {counts}")
    print(f"  eval step: count accuracy "
          f"{metrics['count_accuracy_mode'].item():.4f} (mode, random "
          f"weights), parameters unchanged", flush=True)
    return counts, state, step


def step_kernel_phase(st_kernel, state, step, bw, f32_peak):
    """One more train step with every kernel call's inputs recorded, then
    each kernel against plain and timed on exactly those inputs: the
    windows, images and cotangents that the step really gives them.
    Returns the forward and backward rows, in the order of the calls."""
    calls = []
    kernels = st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda

    def record_fwd(img, zw, out_shape, *args):
        calls.append(("fwd", img.clone(), zw.clone(), None, tuple(out_shape),
                      None))
        return kernels[0](img, zw, out_shape, *args)

    def record_bwd(img, zw, g, out_shape, compute_dtype="float32",
                   need_img=True):
        calls.append(("bwd", img.clone(), zw.clone(), g.clone(),
                      tuple(out_shape), need_img))
        return kernels[1](img, zw, g, out_shape, compute_dtype, need_img)

    st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda = (record_fwd,
                                                              record_bwd)
    try:
        step(state)
    finally:
        st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda = kernels
    torch.cuda.synchronize()
    rows = {"fwd": [], "bwd": []}
    for kind, img, zw, g, out_shape, need_img in calls:
        n, h, w = img.shape
        what = {(16, 16): "synth paste", (20, 20): "paste"}.get((h, w),
                                                                "gather")
        name = (f"step {what}{' bwd' if kind == 'bwd' else ''} "
                f"{h}x{w}->{out_shape[0]}x{out_shape[1]}"
                f"{'' if need_img is not False else ', g_zw only'} "
                f"#{len(rows[kind]) + 1}")
        row = {"case": name, "n": n}
        if kind == "fwd":
            msg = check_gather(st_kernel, row, img, zw, out_shape)
            msg += "; " + time_gather(st_kernel, row, img, zw, out_shape, bw,
                                      f32_peak)
        else:
            msg = check_bwd(st_kernel, row, img, zw, g, out_shape, need_img)
            msg += "; " + time_gather_bwd(st_kernel, row, img, zw, g,
                                          out_shape, need_img, bw, f32_peak)
        print(msg, flush=True)
        rows[kind].append(row)
    for kind, label in (("fwd", "forward"), ("bwd", "backward")):
        rs = rows[kind]
        print(f"  the step's {len(rs)} {label} launches: kernel "
              f"{sum(r['ms'] for r in rs) * 1e3:.2f} us, bound "
              f"{sum(r['bound_ms'] for r in rs) * 1e3:.2f} us, plain "
              f"{sum(r['plain_ms'] for r in rs) * 1e3:.2f} us, library "
              f"{sum(r['library_ms'] for r in rs) * 1e3:.2f} us", flush=True)
    return rows["fwd"], rows["bwd"]


def plain_step_phase(air, st_kernel, limits):
    """One step's loss and gradients through the kernels and through the
    plain ST, same parameters, batch and noise; returns the errors."""
    from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
    from attend_infer_repeat_torch.train import prior_success_prob
    from attend_infer_repeat_torch.train.step import (
        kl_warmup, make_objective_loss_fn)

    results = {}
    for name in ("canonical", "canonical_fast"):
        cfg = air.get_config(name)
        n = cfg.train.batch_size
        bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
        gen = torch.Generator("cuda").manual_seed(3)
        imgs, _ = make_synth_fn(cfg.data, bank)(n, gen)
        imgs = imgs.clone()
        state = air.create_train_state(cfg, seed=1)
        noise = state.model.sample_noise(n, gen)
        names, params = zip(*state.model.named_parameters())

        def grads():
            loss, _ = make_objective_loss_fn(
                cfg, state.model, imgs, None, prior_success_prob(cfg.prior, 0),
                kl_warmup(cfg, 0), noise)()
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            return loss.item(), [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(params, gs)]

        loss_k, g_k = grads()
        kernels = (st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda)
        st_kernel.st_gather_cuda = st_kernel.st_gather_plain
        st_kernel.st_gather_bwd_cuda = st_kernel.st_gather_bwd_plain
        try:
            loss_p, g_p = grads()
        finally:
            st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda = kernels
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        errs = {nm: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
                for nm, a, b in zip(names, g_k, g_p)}
        worst = max(errs, key=errs.get)
        results[name] = (loss_rel, errs[worst])
        loss_lim, grad_lim = limits[name]
        print(f"  {name} (batch {n}): loss kernel {loss_k:.6f} plain "
              f"{loss_p:.6f} (rel err {loss_rel:.3g}, limit {loss_lim}); "
              f"gradient rel L2 err max {errs[worst]:.3g} ({worst}), "
              f"median {statistics.median(errs.values()):.3g}, limit "
              f"{grad_lim}", flush=True)
        if not (loss_rel <= loss_lim and errs[worst] <= grad_lim):
            raise AssertionError(f"{name}: the step through the kernels "
                                 f"disagrees with the plain ST")
    return results


def loop_rows(workdir):
    return [json.loads(line) for line in
            Path(workdir, "metrics.jsonl").read_text().splitlines()]


def check_loop_rows(rows, detect, steps, what):
    """The JSONL schedule of a loop run, and every metric finite."""
    want = []
    for s in steps:
        want += [(s, "train"), (s, "eval"), (s, "train_eval")]
        if s == detect:
            want.append((s, "basin"))
    got = [(r["step"], r["split"]) for r in rows]
    if got != want:
        raise AssertionError(f"{what}: JSONL rows {got}, expected {want}")
    bad = [(r["step"], r["split"], k) for r in rows for k, v in r.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: metrics not finite: {bad}")


def state_arrays(state):
    """Parameters and optimizer state of a ``TrainState``, by name."""
    out = dict(state.model.state_dict())
    for g, st in state.opt_state.items():
        for kind in ("nu", "trace"):
            for i, t in enumerate(getattr(st, kind)):
                out[f"opt/{g}/{kind}/{i}"] = t
    return out


def loop_phase(air, st_kernel, smi):
    """``train()`` on canonical_fast at batch 1024; a resumed run against
    an uninterrupted one; then the CLI.  Returns the forward and backward
    launches of the uninterrupted run."""
    from attend_infer_repeat_torch.train.step import StepGraph

    fast = air.get_config("canonical_fast")
    half = LOOP_STEPS // 2
    # the basin detector runs at step 100 and logs its statistic; the
    # 0.0 threshold keeps random-weight runs from restarting
    cfg = dataclasses.replace(fast, train=dataclasses.replace(
        fast.train, n_iters=LOOP_STEPS, scan_steps=half, log_every=half,
        save_every=half, fig_every=half, eval_batches=2,
        basin_detect_step=half, basin_accuracy_threshold=0.0))
    kw = dict(use_tensorboard=False)
    with tempfile.TemporaryDirectory(prefix="air_loop_") as tmp:
        whole, resumed = os.path.join(tmp, "whole"), os.path.join(tmp, "res")
        st_kernel.launches = st_kernel.bwd_launches = 0
        (state, dt) = timed(air.train, cfg, workdir=whole, **kw)
        counts = (st_kernel.launches, st_kernel.bwd_launches)
        if state.step != LOOP_STEPS:
            raise AssertionError(f"train() stopped at step {state.step}")
        # one graph: its warm-up steps run eagerly, then every step is a
        # replay; the log points add forward launches only
        n_bwd = 6 * (LOOP_STEPS + StepGraph.WARMUP)
        if counts[1] != n_bwd or counts[0] < 7 * (LOOP_STEPS
                                                  + StepGraph.WARMUP):
            raise AssertionError(f"train(): launches {counts}, expected "
                                 f"{n_bwd} backward and 7 forward a step")
        check_loop_rows(loop_rows(whole), half, (half, LOOP_STEPS),
                        "uninterrupted run")
        best = json.loads(Path(whole, "ckpt_best", "best.json").read_text())
        if not Path(whole, "ckpt_best", str(best["step"]), "state.pt").exists():
            raise AssertionError(f"best checkpoint missing: {best}")
        ckpts = sorted(int(p.name) for p in Path(whole, "ckpt").iterdir()
                       if p.name.isdigit())
        if ckpts != [half, LOOP_STEPS]:
            raise AssertionError(f"checkpoints {ckpts}")
        print(f"  train() {LOOP_STEPS} steps (canonical_fast, batch "
              f"{N_TRAIN}, K={half}, graphed): {dt:.2f} s wall with 2 "
              f"log/eval/save "
              f"points, the basin statistic and figure attempts; "
              f"{counts[0]} forward and {counts[1]} backward launches; "
              f"best {best} on {smi}", flush=True)

        air.train(cfg, workdir=resumed, n_iters=half, **kw)
        again = air.train(cfg, workdir=resumed, **kw)
        a, b = state_arrays(state), state_arrays(again)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ or again.step != state.step:
            raise AssertionError(f"resumed run differs from the "
                                 f"uninterrupted one in {differ[:5]}")
        check_loop_rows(loop_rows(resumed), half, (half, LOOP_STEPS),
                        "resumed run")
        print(f"  {half} steps, then a resume to {LOOP_STEPS}: parameters "
              f"and optimizer state ({len(a)} tensors) bit-equal to the "
              f"uninterrupted run", flush=True)

        cli = os.path.join(tmp, "cli")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "attend_infer_repeat_torch.train",
             "--config", "canonical_fast", "--iters", "2", "--workdir", cli,
             "--no-tensorboard"], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t
        if proc.returncode:
            raise AssertionError(f"CLI run failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        rows = loop_rows(cli)
        check_loop_rows(rows, None, (2,), "CLI run")
        ev = next(r for r in rows if r["split"] == "eval")
        print(f"  CLI: 2 canonical_fast steps in a new process, {dt:.1f} s "
              f"wall (start-up, build cache hit, 8+8 eval batches, save); "
              f"eval elbo {ev['elbo']:.2f}", flush=True)
    return counts


def state_gap(a, b):
    """``(tensors that differ, worst name, worst rel L2 err)`` between the
    parameters and optimizer state of two ``TrainState``s."""
    x, y = state_arrays(a), state_arrays(b)
    errs = {k: ((x[k] - y[k]).norm() / y[k].norm().clamp(min=1e-30)).item()
            for k in x if not torch.equal(x[k], y[k])}
    worst = max(errs, key=errs.get) if errs else None
    return len(errs), worst, errs.get(worst, 0.0)


def rows_gap(got, want):
    """Per metric, the largest rel err of the rows (0 where equal)."""
    return {k: 0.0 if torch.equal(got[k], want[k]) else
            ((got[k] - want[k]).abs() / want[k].abs().clamp(min=1e-30))
            .max().item() for k in want}


def hold_to_step_limits(what, n_differ, worst, err, rows):
    """Bit-equal, or within phase 6's ``canonical_fast`` limits (loss rows
    as the loss, every other tensor and row as the gradients)."""
    loss_lim, lim = STEP_LIMITS["canonical_fast"]
    ok = (err <= lim and rows.get("loss", 0.0) <= loss_lim
          and all(v <= lim for k, v in rows.items() if k != "loss"))
    if n_differ == 0 and not any(rows.values()):
        return "bit-equal"
    msg = (f"{n_differ} tensors differ (worst {worst}: rel L2 {err:.3g}), "
           f"metric rows up to {max(rows.values()):.3g} rel "
           f"({max(rows, key=rows.get)})")
    if not ok:
        raise AssertionError(f"{what}: {msg}, over the limits "
                             f"{STEP_LIMITS['canonical_fast']}")
    return msg + f", within {STEP_LIMITS['canonical_fast']}"


def graph_phase(air, st_kernel, smi, bank):
    """``make_scan_train_step`` on canonical_fast at batch 1024 through
    its CUDA graph against the same steps run eagerly, for K = 4 and 100;
    then step walls, eager and graphed, with remat ``save_st`` and off.
    Returns the launch counts of that run and the step walls."""
    from attend_infer_repeat_torch.train.step import StepGraph
    from attend_infer_repeat_torch.utils import debug_mode

    fast = air.get_config("canonical_fast")
    k_full = fast.train.scan_steps
    per_step = (1 + 2 * fast.model.max_steps, 2 * fast.model.max_steps)
    st_kernel.launches = st_kernel.bwd_launches = 0
    expected = [0, 0]
    walls = {}
    for remat in (True, False):
        cfg = dataclasses.replace(fast, model=dataclasses.replace(
            fast.model, remat=remat))
        tag = "remat save_st" if remat else "remat off"
        for k in ((4, k_full) if remat else (k_full,)):
            graphed = air.create_train_state(cfg, seed=4)
            eager = air.create_train_state(cfg, seed=4)
            scan = air.make_scan_train_step(cfg, graphed.model, bank, k)
            (graphed, rows), dt_capture = timed(scan, graphed)
            with debug_mode(nans=False):
                eager_scan = air.make_scan_train_step(cfg, eager.model, bank,
                                                      k)
                (eager, want), dt_eager = timed(eager_scan, eager)
            for i, n in enumerate(per_step):
                expected[i] += n * (StepGraph.WARMUP + 2 * k)
            counts = (st_kernel.launches, st_kernel.bwd_launches)
            if list(counts) != expected:
                raise AssertionError(f"graphed K={k} ({tag}): launches "
                                     f"{counts}, expected {expected}")
            if graphed.step != eager.step or any(
                    graphed.opt_state[g].count != eager.opt_state[g].count
                    for g in eager.opt_state):
                raise AssertionError(f"K={k}: step or counts differ")
            gap = hold_to_step_limits(f"graphed K={k} ({tag})",
                                      *state_gap(graphed, eager),
                                      rows_gap(rows, want))
            check_metrics(rows, f"graphed K={k}")
            print(f"  graphed chunk K={k} ({tag}) vs the same {k} steps "
                  f"eager from one state: parameters, optimizer state "
                  f"({len(state_arrays(eager))} tensors) and {len(rows)} "
                  f"metric rows {gap}; capture + {k} replays "
                  f"{dt_capture:.2f} s, eager {dt_eager:.2f} s", flush=True)
            if k == k_full:
                chunk = []
                for _ in range(3):
                    (graphed, rows), dt = timed(scan, graphed)
                    chunk.append(dt / k)
                    check_metrics(rows, "graphed chunk")
                for i, n in enumerate(per_step):
                    expected[i] += n * 3 * k
                walls[tag] = {"eager_ms": dt_eager / k * 1e3,
                              "graph_ms": statistics.median(chunk) * 1e3,
                              "graph_ms_all": [c * 1e3 for c in chunk]}
                w = walls[tag]
                print(f"  step wall ({tag}): eager {w['eager_ms']:.3f} ms "
                      f"({N_TRAIN / w['eager_ms'] * 1e3:.1f} train img/s), "
                      f"graphed {w['graph_ms']:.3f} ms median of 3 chunks "
                      f"of {k} ({', '.join(f'{c:.3f}' for c in w['graph_ms_all'])}"
                      f"; {N_TRAIN / w['graph_ms'] * 1e3:.1f} train img/s), "
                      f"{w['eager_ms'] / w['graph_ms']:.2f}x, batch "
                      f"{N_TRAIN} on {smi}", flush=True)
    on, off = walls["remat save_st"], walls["remat off"]
    print(f"  remat save_st's step-time cost: eager "
          f"{100 * (on['eager_ms'] / off['eager_ms'] - 1):+.1f} %, graphed "
          f"{100 * (on['graph_ms'] / off['graph_ms'] - 1):+.1f} %", flush=True)
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    if list(counts) != expected:
        raise AssertionError(f"graph phase: launches {counts}")
    return counts, walls


def mesh_phase(air, st_kernel, bank):
    """The data-parallel steps on a one-rank NCCL mesh against the plain
    step; returns the launch counts of that run."""
    import torch.distributed as dist
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.parallel import (
        make_mesh, make_shardmap_train_step)

    fast = air.get_config("canonical_fast")
    mesh = make_mesh()
    print(f"  mesh {mesh} on the {dist.get_backend()} backend", flush=True)
    st_kernel.launches = st_kernel.bwd_launches = 0
    try:
        plain = air.create_train_state(fast, seed=6)
        meshed = air.create_train_state(fast, seed=6)
        plain, mp = air.make_train_step(fast, plain.model,
                                        digit_bank=bank)(plain)
        meshed, mm = air.make_train_step(fast, meshed.model, digit_bank=bank,
                                         mesh=mesh)(meshed)
        gap = hold_to_step_limits("mesh step", *state_gap(meshed, plain),
                                  rows_gap(mm, mp))
        print(f"  mesh step vs plain step: {gap}", flush=True)

        imgs, nums = make_synth_fn(fast.data, bank)(
            N_TRAIN, torch.Generator("cuda").manual_seed(5))
        imgs = imgs.clone()
        a = air.create_train_state(fast, seed=7)
        b = air.create_train_state(fast, seed=7)
        a, ma = air.make_train_step(fast, a.model)(a, (imgs, nums))
        b, mb = make_shardmap_train_step(fast, b.model, bank, mesh,
                                         external_batch=True)(b, (imgs, nums))
        gap = hold_to_step_limits("shard-map step", *state_gap(b, a),
                                  rows_gap(mb, ma))
        print(f"  external-batch shard-map step vs plain step on one "
              f"batch: {gap}", flush=True)
        c = air.create_train_state(fast, seed=8)
        step = make_shardmap_train_step(fast, c.model, bank, mesh)
        for _ in range(2):
            c, mc = step(c)
            check_metrics(mc, "per-rank shard-map step")
        print(f"  per-rank shard-map step: 2 steps, elbo "
              f"{mc['elbo'].item():.2f}", flush=True)
    finally:
        dist.destroy_process_group()
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    # 6 steps, 2 of them on an injected batch (no synthesis), and the
    # synthesis of that batch
    if counts != (6 * 7 - 2 + 1, 6 * 6):
        raise AssertionError(f"mesh phase: launches {counts}")
    return counts


def utils_phase(air, bank):
    """``utils.trace`` around a graphed chunk; ``debug_mode`` trapping a
    NaN in a train step's batch."""
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.utils import debug_mode, trace

    fast = air.get_config("canonical_fast")
    with tempfile.TemporaryDirectory(prefix="air_trace_") as logdir:
        # the profiler is brought up before the capture, so that it sees
        # the replayed kernels one by one
        with trace(os.path.join(logdir, "first")):
            torch.ones(1, device="cuda").add_(1)
        state = air.create_train_state(fast, seed=9)
        scan = air.make_scan_train_step(fast, state.model, bank, 4)
        state, _ = scan(state)
        logdir = os.path.join(logdir, "chunk")
        with trace(logdir, annotate="graphed chunk"):
            state, _ = scan(state)
            torch.cuda.synchronize()
        files = [p for p in Path(logdir).rglob("*") if p.is_file()]
        if len(files) != 1:
            raise AssertionError(f"trace files: {files}")
        events = json.loads(files[0].read_text())["traceEvents"]
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        kernels = sum("st_gather" in n for n in names)
        if not (any(e.get("name") == "graphed chunk" for e in events)
                and names):
            raise AssertionError("the trace lacks the annotation or any "
                                 "device kernel")
        print(f"  trace of a graphed chunk of 4: {files[0].name}, "
              f"{files[0].stat().st_size / 1e6:.2f} MB, {len(names)} "
              f"kernels, {kernels} of them the ST kernels (4 replays of "
              f"13)", flush=True)

    other = air.create_train_state(fast, seed=10)
    step = air.make_train_step(fast, other.model, digit_bank=bank)
    imgs, nums = make_synth_fn(fast.data, bank)(
        N_TRAIN, torch.Generator("cuda").manual_seed(6))
    imgs = imgs.clone()
    imgs[3, 20, 20] = float("nan")
    try:
        with debug_mode(nans=True):
            step(other, (imgs, nums))
    except FloatingPointError as e:
        print(f"  debug_mode trapped the injected NaN: {e}", flush=True)
    else:
        raise AssertionError("debug_mode did not trap the injected NaN")


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

    print(f"[3b] backward kernel against plain (limits g_img, g_zw: "
          f"{BWD_TOL} of max(1, max|plain|), f32 and bf16)", flush=True)
    bwd_rows = bwd_phase(st_kernel, invert_where, bw, f32_peak)

    print("[4] the serving slice", flush=True)
    launches = slice_phase(air, st_kernel, smi)

    print("[5] the train step", flush=True)
    from attend_infer_repeat_torch.data import load_digit_bank
    fast = air.get_config("canonical_fast")
    bank, _ = load_digit_bank(fast.data.source, fast.data.digit_size)
    (train_launches, bwd_launches), state, step = train_phase(
        air, st_kernel, smi, bank)

    print("[5b] both kernels on one train step's own inputs", flush=True)
    step_rows, step_bwd_rows = step_kernel_phase(st_kernel, state, step, bw,
                                                 f32_peak)
    del state, step

    print("[5c] the K-step chunk as a replayed CUDA graph", flush=True)
    (graph_launches, graph_bwd_launches), walls = graph_phase(
        air, st_kernel, smi, bank)

    print("[6] one step through the plain ST on the card", flush=True)
    plain_step_phase(air, st_kernel, STEP_LIMITS)

    print("[7] the training loop", flush=True)
    loop_launches, loop_bwd_launches = loop_phase(air, st_kernel, smi)

    print("[7b] data parallelism on a one-rank NCCL mesh", flush=True)
    mesh_launches, mesh_bwd_launches = mesh_phase(air, st_kernel, bank)

    print("[7c] utils: a trace of a graphed chunk, the NaN trap", flush=True)
    utils_phase(air, bank)

    def kernel_line(name, source, replaces, launches, rows, head_case):
        timed = [r for r in rows if "ms" in r]
        head = next(r for r in timed if head_case(r["case"], r["n"]))
        keys = ("case", "n", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")
        return {
            "name": name, "route": "cuda",
            "source": f"attend_infer_repeat_torch/csrc/{source}",
            "replaces": f"attend_infer_repeat_tpu/ops/pallas_st.py:{replaces}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_abs_err_bf16": max(r["max_abs_err_bf16"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": f"{head['case']} N={head['n']}",
            "shapes": [{k: r[k] for k in keys} for r in timed],
        }

    kernels = [
        kernel_line("st_gather", "st_gather.cu", 54,
                    launches + train_launches + graph_launches
                    + loop_launches + mesh_launches,
                    rows + step_rows,
                    lambda c, n: (c, n) == ("gather 50x50->20x20", N_SERVE)),
        kernel_line("st_gather_bwd", "st_gather_bwd.cu", 155,
                    bwd_launches + graph_bwd_launches + loop_bwd_launches
                    + mesh_bwd_launches,
                    bwd_rows + step_bwd_rows,
                    lambda c, n: c.startswith("step paste bwd")),
    ]
    print("[8] kernels", flush=True)
    print(f"  total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
