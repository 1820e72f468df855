"""Drive the PyTorch port of AIR (serving and training) on one NVIDIA GPU
and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the gather kernel and its backward (``csrc/``) with one
   nvcc call;
3. kernel against plain: the gather kernel and its plain PyTorch version
   on the same inputs at the serving and train paths' shapes (gather
   50×50→20×20, paste 20×20→50×50, synthesis paste 16×16→50×50; SPACE's
   render paste 32×32→128×128 and synthesis paste 16×16→128×128), f32 and
   bf16 modes, edge cases, and the windows of ``WINDOW_CASES`` (each
   names the kernel branch it reaches); times of the kernel, the plain
   version and one PyTorch library call of the same function
   (``grid_sample``), beside the bound of the bytes and FLOP that this
   run's inputs need (``gather_work``);
3b. the backward kernel against its plain version in the same way, at
   the train step's shapes (SPACE's render paste too, both gradients)
   and at N = 8192, ragged N and an odd shape;
   edge cases and ``WINDOW_CASES``; two runs bit-identical; the library
   call is ``grid_sample``'s backward; the bound counts the cotangent only
   where it has a tap (``gather_bwd_work``);
3c. the fused paste (``st_gather_accumulate_cuda``: the paste with the
   cell's canvas update, presence mask, f32 add and cast to the carry)
   against the unfused ops, bit for bit in the canvas and in the
   canvas's, glimpse's and window's gradients, and against its plain
   version at the gather's limits, with an f32 and a bf16
   carry, at the serve shape (N = 8192) and the ``canonical_fast`` and
   ``crowded`` step shapes, and on ``WINDOW_CASES``; each timed beside
   its plain version, the unfused ops and its bound (``accumulate_work``);
3e. the indexed gather (``st_gather_cuda(..., src=...)``, SPACE's 256
   glimpses of every channel of a scene) and its window gradient against
   their plain versions (the plain gather of ``img[src]``, at F32_TOL and
   BWD_TOL) and against the one-to-one kernels on materialised copies
   ``img[src]``, bit for bit, at SPACE's step shape (24,576 windows of 96
   images, 128×128 → 32×32) and a ragged one; each timed beside its plain
   version, the copies' kernel (the copy not counted) and its bound (the
   images read once, the windows and outputs once: ``indexed_work``);
3d. the LSTM cell's pointwise kernels (``csrc/lstm_cell.cu``) against
   their plain twins, bit for bit, at the main paths' rows of 256 hidden
   units (``LSTM_ROWS``), with ``c_prev`` a row-strided slot and
   contiguous, the backward with both cotangents, ``dh`` absent and
   ``dc`` absent; each timed beside the unfused ops (autograd's backward
   of them), PyTorch's own fused cell (``aten._thnn_fused_lstm_cell``
   and its backward, whose differing bits are counted, not held) and
   its bound (``lstm_work``);
4. the serving slice: canvas synthesis, serving requests through
   ``make_infer_fn`` for the ``serving`` preset and the ``canonical_fast``
   model, ``make_generate_fn``, all through their CUDA graphs; launch
   counts read around that run (a graph's first call adds its warm-up
   runs), the fused paste among them at batch 8192; one request rerun
   eagerly through the plain spatial transformer and compared;
5. the train step: ``canonical_fast`` at batch 1024 through
   ``create_train_state`` and ``make_train_step``, eagerly
   (``utils.debug_mode``; warm-up, then timed steps) and through the
   step's CUDA graph from the same state, held bit-equal and both timed,
   then one eager ``make_eval_step``; launch counts read around that run
   (per step: 1 synthesis paste, 6 forward, 6 backward launches; the
   preset's remat ``save_st`` recomputes no ST kernel; 6 forward and 3
   backward LSTM launches, the forward recomputed);
5b. one more eager step with every kernel call's inputs recorded; each
   kernel against plain (the fused paste against the unfused ops) and
   timed on the windows, images and cotangents that the step really
   gives it (after the counts were read);
5c. the K-step chunk as a replayed CUDA graph (``make_scan_train_step``):
   for K = 4 and the preset's 100, the graphed chunk and the same K steps
   run eagerly (``utils.debug_mode``) from one state must agree bit for
   bit in parameters, optimizer state and every metric row (else the
   largest gap is printed and held to phase 6's ``canonical_fast``
   limits); launch counts read around that run (a replay counts the
   launches of one captured step; 3 fused pastes a step); then step
   wall and train img/s,
   eager and graphed, with the preset's remat ``save_st`` and with remat
   off;
5d. the JAX package's other jitted entry points as CUDA graphs against
   their eager calls at full width, from one generator state: infer
   (``serving`` and the ``canonical_fast`` model) and generate at batch
   8192, tiled infer at 16384 (tile 8192), synthesis, eval and IWAE at
   1024, the single train step on an external host batch; results
   bit-equal, generators left in one state, both walls and each graph's
   memory pool printed; launch counts read around that run;
5e. SPACE's train step at its benchmark configuration
   (``air_bench/configs/space_g16.json``, read as data: batch 32, 128 ×
   128 RGB scenes, 256 cells): two graphed calls of ``SPACE_K`` steps
   through ``make_scan_train_step`` against the same steps run eagerly
   from the same state, bit for bit; the ST launches by shape a step (the
   synthesis paste, the indexed gather, the render's paste; the indexed
   g_zw, the paste's backward) and ``space_counts`` held; the counters
   are set to 0 just before it, so that the ``kernels`` line counts the
   indexed kernels' launches;
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
   eagerly, the mesh step and the external-batch shard-map step against
   the plain step from the same state, and a per-rank shard-map step;
   then every mesh entry point as a CUDA graph that holds its NCCL
   collectives, against its eager call from the same state and
   generator state, bit-equal: the mesh step (and the graphed plain
   step held to it within the step limits and timed in turns with it),
   both shard-map forms, the K = 4 chunk, sharded infer (one pass and
   tiled) and generate at batch 8192; graphed and eager walls, each
   graph's pool and the phase's launches, beside the card;
7c. ``utils.trace`` around a graphed chunk writes a trace that holds the
   replayed kernels, and ``utils.debug_mode`` traps a NaN injected into
   a train step's batch;
7d. the reference workflow, through each tool's ``main(argv)`` in this
   process, in a temporary directory: ``scripts/torch_create_dataset.py``
   at its defaults (60,000 + 10,000 canvases, 18 synthesis calls, one
   paste launch each after the 2 graphs' warm-ups; the pickles' keys,
   dtypes, counts and pixel range; a second write byte-equal);
   ``train()`` from those pickles with the data resident on the card
   (phase 7's schedule, the launches, a resume bit-equal), the steady
   step wall of the resident chunk against the synthesis-fed one in
   turns; ``train()`` streamed from the host for 50 steps and what sets
   its pace (the host's batch assembly, the copy, the graph); the CLI
   with ``--data``/``--eval-data`` in a new process;
   ``scripts/torch_eval_checkpoint.py`` on the resident run (latest with
   ``--iwae``, and ``--best``: restored steps, a confusion total of
   16 × 1024, the JAX script's keys, the launches);
   ``scripts/torch_run_variant.py`` with ``remat=False`` and
   ``scan_steps=50``; ``scripts/torch_make_explainaway_fig.py``'s
   selection on the resident run, and its render's ``ImportError``
   without matplotlib;
7e. the analysis tools, through each tool's ``main(argv)`` in this
   process, in a temporary directory: ``train()`` of
   ``canonical_uniform28`` and ``iwae`` to 200 steps for their
   checkpoints; ``scripts/torch_characterize_overlap.py`` at its defaults
   (three presets, 65,536 canvases each, synthesized in chunks of 8192);
   ``torch_analyze_overlap_errors.py`` on the u28 checkpoint (16 × 1024
   held-out scenes); ``torch_supervised_ceiling.py`` for 200 steps, its
   ``CountCNN`` train step graphed against 4 eager steps from one state
   and one generator state and its graphed ``predict`` against eager,
   bit-equal; ``torch_iwae_ksweep.py`` at k = 1, 5, 25, then k = 64 on one
   batch (the gather at N = 65,536); ``torch_parity_check.py`` at
   ``canonical`` batch 16, the CPU against the card held to phase 4's
   limits of the kernel path against the plain ST (canvas ≤ 1e-4, ELBO
   rel ≤ 1e-5, on the examples whose presence agrees), and its
   comparison at ``canonical_fast`` batch 1024, whose bf16 roundings
   differ between the devices: reported beside each device's distance
   from the same forward in f32, not held;
   ``torch_ablate_canonical.py`` and
   ``torch_probe_u28.py`` for one variant each at 20 steps; each tool's
   wall and launches by shape; then both kernels against plain and timed
   on the IWAE forward's own inputs at k = 25 and 64 and on the uniform
   presets' synthesis pastes at N = 16384, each of whose shapes the phase
   must have launched;
8. every other training preset (``PRESET_LAUNCHES``: ``crowded``,
   ``iwae_trained``, ``iwae``, ``canonical_uniform``,
   ``canonical_uniform28``, ``single_digit``, ``canonical``, ``no_nvil``)
   at its own batch, widths, canvas and dtype mix, from
   ``create_train_state``: K = 4 steps through its captured chunk (its
   single-step graph for ``no_nvil``, which has no ``scan_steps``) and
   the same steps eager (``utils.debug_mode``) from one state, twice,
   bit-equal in parameters, optimizer state, metric rows, step and
   counts; launches per step held to what the code gives; the log
   point's graphs (synthesis, eval, IWAE where the preset logs it)
   against eager; step walls, peak memory and graph pools; then
   ``train()`` on ``crowded`` with its cap switching on at step K,
   graphed against eager, bit-equal; the phase's launches by shape
   (``st_kernel.shape_launches``);
8b. both kernels on one ``crowded`` step's own inputs (the 5 gathers
   100×100→20×20, the 5 pastes 20×20→100×100, the synthesis paste
   16×16→100×100 at N = 5×1024, their backwards), against plain and
   timed, as phase 5b; each of those shapes must have been launched in
   phase 8;
9. a ``kernels`` JSON line (``st_gather``, ``st_gather_accumulate`` and
   ``st_gather_bwd``: each one's launches in the phases that run the
   program, 4 to 8 without 5b, 6, 7c and 8b, counted by shape, and its
   launches by shape in phases 7e and 8; ``lstm_cell`` and
   ``lstm_cell_bwd``: their launches in the same phases, from
   ``modules.lstm_counts`` set to 0 before phase 4, and phase 3d's
   rows; ``st_gather_indexed`` and ``st_gather_bwd_indexed``: their
   launches in phase 5e, and phase 3e's rows with their bounds), then the
   last line
   ``{"ok": true, "device": {...}}``.

Phases 3 and 3b include the ``crowded`` preset's 100×100 canvas, and a
NaN and an infinity in the image and the cotangent against the plain
versions' pattern.  The ``kernels`` line counts every launch of the main
paths (phases 4, 5, 5c, 5d, 5e, 7, 7b, 7d, 7e and 8): eager launches, and for a
replayed graph the launches of one captured run times its replays; the
``crowded`` step rows carry the number of ``crowded`` steps of phase 8,
each of which launched each of them once.  Imports nothing of JAX.
Needs one card; stops no process it did not start (it starts
``nvidia-smi``, ``nvcc`` and the CLI runs, and waits for each).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
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

# The LSTM cell's rows on the main paths, at its hidden width: the
# canonical_fast and crowded train batch, k = 5 particles of it
# (iwae_trained, SQAIR), a bulk request.
LSTM_ROWS = (N_TRAIN, 5 * N_TRAIN, N_SERVE)
LSTM_HIDDEN = 256
L2_BYTES = 50 * 2 ** 20     # the H100's L2: timed inputs cycle past it

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
    # cuDNN's grid sampler takes N < 65536; PyTorch's own kernel the rest
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled and n < 65536
    try:
        return F.grid_sample(img[:, None], grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)[:, 0]
    finally:
        torch.backends.cudnn.enabled = enabled


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

    Bytes: the whole input read once (a NaN or an infinity at any pixel
    changes the result, as in the dense form, so every pixel is needed),
    ``zw`` read and the output written once.  FLOP: one multiply-add per
    nonzero tap pair.  Also returns the share of the input that the taps
    touch.
    """
    touched, _, taps = tap_support(zw, in_shape, out_shape)
    n = zw.shape[0]
    nbytes = 4 * n * (in_shape[0] * in_shape[1] + 4
                      + out_shape[0] * out_shape[1])
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


def bits_differ(a, b) -> int:
    """Entries whose bits differ (two NaNs count as equal)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype:
        return a.numel()
    same = a.view(ints[a.dtype]) == b.view(ints[b.dtype])
    return int((~same & ~(torch.isnan(a) & torch.isnan(b))).sum())


def check_accumulate(st_kernel, row, canvas, glimpse, zw, z_pres):
    """The fused paste with an f32 and a bf16 carry against the unfused
    ops, bit for bit: the canvas, and the canvas's, glimpse's and window's
    gradients.  Then against its plain version at the gather's limits:
    the canvas to ``F32_TOL`` (a bf16 carry through the same values
    carried in f32, whose result it must be, rounded), the glimpse's and
    window's gradients to ``BWD_TOL``.  Errors into ``row``, raises on a
    miss; returns the message."""
    unfused = functools.partial(st_kernel.st_gather_accumulate_plain,
                                paste=st_kernel.STGather.apply)
    out_shape = tuple(canvas.shape[1:])
    name = f"{row['case']} N={row['n']}"
    g = torch.randn(canvas.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7))
    for carry, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        c, g_out = canvas.to(carry), g.to(carry)
        outs, grads = [], []
        for fn in (st_kernel.STGatherAccumulate.apply, unfused):
            leaves = [t.clone().requires_grad_() for t in (c, glimpse, zw)]
            out = fn(*leaves, z_pres)
            out.backward(g_out)
            outs.append(out.detach())
            grads.append([t.grad for t in leaves])
        wide = st_kernel.st_gather_accumulate_cuda(c.float(), glimpse, zw,
                                                   z_pres)
        plain = st_kernel.st_gather_accumulate_plain(c.float(), glimpse, zw,
                                                     z_pres)
        g_plain = st_kernel.st_gather_bwd_plain(
            glimpse, zw, z_pres[:, None, None] * g_out.float(), out_shape)
        torch.cuda.synchronize()
        differ = [bits_differ(*outs)] + [bits_differ(a, b)
                                         for a, b in zip(*grads)]
        if any(differ):
            raise AssertionError(
                f"{name} {carry}: the fused paste differs from the unfused "
                f"ops in {differ} entries (canvas, then the canvas's, "
                f"glimpse's and window's gradients)")
        if bits_differ(outs[0], wide.to(carry)):
            raise AssertionError(f"{name} {carry}: the fused paste is not "
                                 f"its f32 carry's result, rounded")
        err = (wide - plain).abs().max().item()
        e_img, e_zw, ok = bwd_errors(grads[0][1:], g_plain)
        if not (err <= F32_TOL and ok):
            raise AssertionError(f"{name} {carry}: the fused paste vs plain "
                                 f"err canvas {err} g_img {e_img} g_zw "
                                 f"{e_zw} over the limit")
        row["max_abs_err" + tag] = err
        row["err_g_img" + tag], row["err_g_zw" + tag] = e_img, e_zw
    return (f"  {name}: bit-equal to the unfused ops (canvas and its 3 "
            f"gradients), f32 and bf16 carry; against plain, f32 carry: err "
            f"{row['max_abs_err']:.3g} g_img {row['err_g_img']:.3g} g_zw "
            f"{row['err_g_zw']:.3g}, bf16 carry: err "
            f"{row['max_abs_err_bf16']:.3g} g_img {row['err_g_img_bf16']:.3g}"
            f" g_zw {row['err_g_zw_bf16']:.3g}")


def accumulate_work(zw, canvas, in_shape):
    """Bytes and FLOP of the fused paste: the canvas read and written
    once at the carry's width, the glimpse, the window and the presence
    read once; the paste's multiply-adds and two operations a pixel."""
    n, out_h, out_w = canvas.shape
    _, flops, _ = gather_work(zw, in_shape, (out_h, out_w))
    nbytes = n * (2 * out_h * out_w * canvas.element_size()
                  + 4 * (in_shape[0] * in_shape[1] + 4 + 1))
    return nbytes, flops + 2 * canvas.numel()


def time_accumulate(st_kernel, row, canvas, glimpse, zw, z_pres, bw,
                    f32_peak):
    """Time the fused paste on these inputs into ``row``, beside its plain
    version and the unfused ops; its text."""
    nbytes, flops = accumulate_work(zw, canvas, tuple(glimpse.shape[1:]))
    with torch.no_grad():
        row.update(timing(
            lambda: st_kernel.st_gather_accumulate_cuda(canvas, glimpse, zw,
                                                        z_pres),
            lambda: st_kernel.st_gather_accumulate_plain(canvas, glimpse, zw,
                                                         z_pres),
            lambda: st_kernel.st_gather_accumulate_plain(
                canvas, glimpse, zw, z_pres, paste=st_kernel.STGather.apply),
            nbytes, flops, bw, f32_peak))
    return timing_text(row, nbytes, "unfused")


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
        # SPACE (space_g16, batch 32): the scenes' synthesis paste and the
        # render's paste of 4 rows a cell
        ("synth paste 16x16->128x128", 32 * 24, (16, 16), (128, 128), True,
         True),
        ("paste 32x32->128x128", 32 * 256 * 4, (32, 32), (128, 128), True,
         True),
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
    nonfinite_phase(st_kernel, invert_where, backward=False)
    return rows


def indexed_work(images, n, side, glimpse, backward):
    """Bytes of an indexed gather (or its g_zw-only backward) with each
    image read once: the images, the windows and indices, and the output
    (or the cotangent and the window gradients)."""
    return 4 * (images * side * side + n * (4 + 1 + glimpse * glimpse)
                + (4 * n if backward else 0))


def indexed_phase(st_kernel, bw):
    """The indexed gather and its g_zw against their plain versions (the
    plain gather of ``img[src]``, F32_TOL and BWD_TOL) and against the
    one-to-one kernels on copies ``img[src]``, bit for bit; timed at
    SPACE's step shape.  Returns the forward's rows and the backward's."""
    gen = torch.Generator("cuda").manual_seed(11)
    rows, bwd_rows = [], []
    for images, n, timed_case in ((96, 24_576, True), (7, 1_023, False)):
        img = torch.rand((images, 128, 128), generator=gen, device="cuda")
        zw = torch.cat([0.05 + 0.9 * torch.rand((n, 2), generator=gen,
                                                device="cuda"),
                        2.5 * torch.rand((n, 2), generator=gen,
                                         device="cuda") - 1.25], 1)
        src = torch.randint(0, images, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        copies = img[src.long()].contiguous()
        g = torch.randn((n, 32, 32), generator=gen, device="cuda")

        def fwd(x, s=None):
            return st_kernel.st_gather_cuda(x, zw, (32, 32), src=s)

        def bwd(x, s=None):
            return st_kernel.st_gather_bwd_cuda(x, zw, g, (32, 32),
                                                need_img=False, src=s)[1]

        def fwd_plain():
            return st_kernel.st_gather_plain(img, zw, (32, 32), src=src)

        def bwd_plain():
            return st_kernel.st_gather_bwd_plain(img, zw, g, (32, 32),
                                                 need_img=False, src=src)[1]

        name = f"indexed gather 128x128->32x32 of {images} images"
        got, got_zw = fwd(img, src), bwd(img, src)
        if not (torch.equal(got, fwd(copies))
                and torch.equal(got_zw, bwd(copies))):
            raise AssertionError(f"{name} N={n}: not bit-equal to the "
                                 f"kernels on copies")
        err = (got - fwd_plain()).abs().max().item()
        _, err_zw, ok = bwd_errors((None, got_zw), (None, bwd_plain()))
        if not (err <= F32_TOL and ok):
            raise AssertionError(f"{name} N={n}: kernel vs plain err {err}, "
                                 f"g_zw {err_zw} over the limit")
        row = {"case": name, "n": n, "max_abs_err": err}
        bwd_row = {"case": name + ", g_zw only (as the step)", "n": n,
                   "max_abs_err": err_zw, "err_g_zw": err_zw}
        msg = (f"  {name} N={n}: bit-equal to the kernels on copies; err "
               f"f32 {err:.3g}, g_zw {err_zw:.3g}")
        if timed_case:
            for r, fn, plain, back in ((row, fwd, fwd_plain, False),
                                       (bwd_row, bwd, bwd_plain, True)):
                nbytes = indexed_work(images, n, 128, 32, back)
                r.update(ms=cuda_ms(lambda: fn(img, src)),
                         copies_ms=cuda_ms(lambda: fn(copies)),
                         plain_ms=cuda_ms(plain),
                         bound_ms=nbytes / bw * 1e3, bound_by="bytes")
                msg += (f"; {'bwd' if back else 'fwd'} kernel "
                        f"{r['ms'] * 1e3:.2f} us, on copies "
                        f"{r['copies_ms'] * 1e3:.2f} us, plain "
                        f"{r['plain_ms'] * 1e3:.2f} us, bound "
                        f"{r['bound_ms'] * 1e3:.2f} us "
                        f"({nbytes / 1e6:.3f} MB)")
        print(msg, flush=True)
        rows.append(row)
        bwd_rows.append(bwd_row)
    return rows, bwd_rows


ACC_KEY = "st_gather_accumulate"


def accumulate_phase(st_kernel, invert_where, bw, f32_peak):
    """The fused paste against the unfused ops (bit for bit, forward and
    backward, both carries) at the cells' shapes, timed beside its plain
    version, the unfused ops and its bound; then on the windows of
    ``WINDOW_CASES``.  Returns the rows."""
    gen = torch.Generator("cuda").manual_seed(5)
    cases = [  # name, N, canvas, carry, timed?
        ("fused paste 20x20->50x50 (serve)", N_SERVE, (50, 50),
         torch.bfloat16, True),
        ("fused paste 20x20->50x50 (canonical_fast step)", N_TRAIN, (50, 50),
         torch.bfloat16, True),
        ("fused paste 20x20->100x100 (crowded step)", N_TRAIN, (100, 100),
         torch.float32, True),
        ("fused paste 20x20->50x50", 17, (50, 50), torch.bfloat16, False),
    ]
    rows = []
    for name, n, canvas_shape, carry, timed_case in cases:
        canvas = torch.rand((n,) + canvas_shape, generator=gen,
                            device="cuda").to(carry)
        glimpse = torch.rand((n, 20, 20), generator=gen, device="cuda")
        zw = invert_where(random_where(n, gen)).contiguous()
        z_pres = (torch.rand(n, generator=gen, device="cuda") < 0.7).float()
        row = {"case": f"{name}, {str(carry)[6:]} carry", "n": n,
               "key": (ACC_KEY, n, 20, 20, *canvas_shape)}
        msg = check_accumulate(st_kernel, row, canvas, glimpse, zw, z_pres)
        if timed_case:
            msg += "; " + time_accumulate(st_kernel, row, canvas, glimpse,
                                          zw, z_pres, bw, f32_peak)
        print(msg, flush=True)
        rows.append(row)
    for kind in WINDOW_CASES:
        n = 257
        zw = branch_where(kind, n, (20, 20), (50, 50), True, gen,
                          invert_where)
        row = {"case": f"fused paste 20x20->50x50, {kind}", "n": n}
        print(check_accumulate(
            st_kernel, row, torch.rand((n, 50, 50), generator=gen,
                                       device="cuda"),
            torch.rand((n, 20, 20), generator=gen, device="cuda"), zw,
            (torch.rand(n, generator=gen, device="cuda") < 0.7).float()),
            flush=True)
        rows.append(row)
    return rows


def lstm_inputs(rows, hidden, gen, slots=3):
    """One set of the LSTM kernels' inputs: ``a`` and ``b`` ``(rows,
    4H)``, ``c_prev`` a slot of a ``(rows, slots, H)`` state (row-strided,
    as SQAIR passes it), and the cotangents ``dh`` and ``dc``."""
    def randn(*shape):
        return 3.0 * torch.randn(shape, generator=gen, device="cuda")

    return (randn(rows, 4 * hidden), randn(rows, 4 * hidden),
            randn(rows, slots, hidden)[:, 1], randn(rows, hidden),
            randn(rows, hidden))


def lstm_work(rows, hidden, backward):
    """Bytes the LSTM kernels must move: the forward reads ``a``, ``b``
    and ``c_prev`` and writes ``c`` and ``h``; the backward reads ``a``,
    ``b``, ``c_prev``, ``dh`` and ``dc`` and writes ``d_gates`` and
    ``dc_prev``.  Their ~30 flops a unit take under 1 us at the f32 peak
    at these shapes, so the bytes bound them."""
    return 4 * rows * hidden * (8 + 3 + 4 + 1 if backward else 8 + 1 + 2)


def library_lstm(a, b, c_prev):
    """PyTorch's own fused LSTM cell (``nn.LSTMCell``'s kernel on CUDA,
    gates i, f, g, o), timed and compared, never used by the port:
    ``(c, h, workspace)``."""
    h, c, workspace = torch.ops.aten._thnn_fused_lstm_cell(a, b, c_prev)
    return c, h, workspace


def library_lstm_bwd(dh, dc, c_prev, c, workspace):
    """Its backward: ``(d_gates, dc_prev)``."""
    bwd = torch.ops.aten._thnn_fused_lstm_cell_backward_impl
    d_gates, dc_prev, _ = bwd(dh, dc, c_prev, c, workspace, False)
    return d_gates, dc_prev


def check_lstm(lstm_kernel, rows, a, b, slot, dh, dc):
    """Both LSTM kernels against their plain twins with ``c_prev`` a
    row-strided slot and contiguous, the backward with both cotangents
    and with either absent; raises on any differing bit.  Returns the
    bits in which PyTorch's fused cell differs from the twins."""
    for c_prev in (slot, slot.contiguous()):
        where = "strided" if c_prev is slot else "contiguous"
        got = lstm_kernel.lstm_cell_cuda(a, b, c_prev)
        want = lstm_kernel.lstm_cell_plain(a, b, c_prev)
        for cots in ((dh, dc), (None, dc), (dh, None)):
            got += lstm_kernel.lstm_cell_bwd_cuda(a, b, c_prev, *cots)
            want += lstm_kernel.lstm_cell_bwd_plain(a, b, c_prev, *cots)
        differ = [bits_differ(g, w) for g, w in zip(got, want)]
        if any(differ):
            raise AssertionError(
                f"LSTM kernels at {rows} rows, c_prev {where}: bits differ "
                f"from the plain twins in (c, h, then d_gates and dc_prev "
                f"with both cotangents, no dh, no dc) {differ}")
    c_prev = slot.contiguous()
    c, h, workspace = library_lstm(a, b, c_prev)
    lib = (c, h, *library_lstm_bwd(dh, dc, c_prev, c, workspace))
    want = (*lstm_kernel.lstm_cell_plain(a, b, c_prev),
            *lstm_kernel.lstm_cell_bwd_plain(a, b, c_prev, dh, dc))
    return {name: bits_differ(g, w) for name, g, w in
            zip(("c", "h", "d_gates", "dc_prev"), lib, want)}


def lstm_phase(bw, f32_peak):
    """The LSTM kernels against their plain twins at ``LSTM_ROWS``, bit
    for bit, and timed on input sets cycled past the L2, each beside the
    unfused ops (forward, and autograd's backward of them), PyTorch's
    fused cell and the bytes bound.  Returns the forward and backward
    rows."""
    from attend_infer_repeat_torch.ops import lstm_kernel

    gen = torch.Generator("cuda").manual_seed(7)
    hidden = LSTM_HIDDEN
    fwd_rows, bwd_rows = [], []
    for rows in LSTM_ROWS:
        first = lstm_inputs(rows, hidden, gen)
        lib_bits = check_lstm(lstm_kernel, rows, *first)
        fwd_bytes = lstm_work(rows, hidden, backward=False)
        bwd_bytes = lstm_work(rows, hidden, backward=True)
        n_sets = max(2, -(-3 * L2_BYTES // fwd_bytes))
        sets = [first] + [lstm_inputs(rows, hidden, gen)
                          for _ in range(n_sets - 1)]
        sets = [(a, b, slot.contiguous(), dh, dc)
                for a, b, slot, dh, dc in sets]
        lib_out = [library_lstm(*s[:3]) for s in sets]
        unfused = []
        for a, b, c_prev, dh, dc in sets:
            a, b, c_prev = (t.detach().requires_grad_()
                            for t in (a, b, c_prev))
            c, h = lstm_kernel.lstm_cell_plain(a, b, c_prev)
            unfused.append(functools.partial(
                torch.autograd.grad, (c, h), (a, b, c_prev), (dc, dh),
                retain_graph=True))
        turn = iter(range(10 ** 9))

        def cycle(fn):
            return lambda: fn(next(turn) % n_sets)

        fwd = {"case": f"lstm forward {rows}x{hidden}", "n": rows,
               "bits_differ": 0, "library_bits_differ": lib_bits}
        fwd.update(timing(
            cycle(lambda i: lstm_kernel.lstm_cell_cuda(*sets[i][:3])),
            cycle(lambda i: lstm_kernel.lstm_cell_plain(*sets[i][:3])),
            cycle(lambda i: library_lstm(*sets[i][:3])),
            fwd_bytes, 0, bw, f32_peak))
        bwd = {"case": f"lstm backward {rows}x{hidden}", "n": rows,
               "bits_differ": 0, "library_bits_differ": lib_bits}
        bwd.update(timing(
            cycle(lambda i: lstm_kernel.lstm_cell_bwd_cuda(*sets[i])),
            cycle(lambda i: unfused[i]()),
            cycle(lambda i: library_lstm_bwd(
                *sets[i][3:], sets[i][2], *lib_out[i][::2])),
            bwd_bytes, 0, bw, f32_peak))
        for row, nbytes in ((fwd, fwd_bytes), (bwd, bwd_bytes)):
            print(f"  {row['case']}: bit-equal to the plain twins; kernel "
                  f"{row['ms'] * 1e3:.2f} us, unfused ops "
                  f"{row['plain_ms'] * 1e3:.2f} us, torch fused cell "
                  f"{row['library_ms'] * 1e3:.2f} us, bound "
                  f"{row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.3f} MB; "
                  f"kernel {row['ms'] / row['bound_ms']:.2f}x); {n_sets} "
                  f"input sets", flush=True)
        print(f"  torch fused cell at {rows} rows: bits that differ from the "
              f"unfused ops {lib_bits} of {rows * hidden} (c, h, dc_prev) "
              f"and {4 * rows * hidden} (d_gates)", flush=True)
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
        del sets, lib_out, unfused
    return fwd_rows, bwd_rows


def same_pattern(kernel, plain) -> bool:
    """NaN, +inf and -inf at the same entries."""
    return all(torch.equal(test(kernel), test(plain))
               for test in (torch.isnan, torch.isposinf, torch.isneginf))


def nonfinite_phase(st_kernel, invert_where, backward):
    """A NaN, +inf or -inf at an input pixel that a tap reaches (example
    0), at one that none reaches (example 1), and none (example 2), at
    the gather and paste shapes in both modes: the kernel gives the plain
    version's pattern of NaN and +-inf, and the finite example the bits
    it has alone.  With ``backward``, the backward kernel, with the value
    in the image and then in the cotangent."""
    from attend_infer_repeat_torch.ops.spatial_transformer import st_weights

    gen = torch.Generator("cuda").manual_seed(3)
    cases = 0
    for in_shape, out_shape, window, paste in (
            # windows that leave the image: some pixels of both the input
            # and the output have no tap
            ((50, 50), (20, 20), [0.5, 0.5, 0.9, 0.0], False),
            ((20, 20), (50, 50), [0.5, 0.5, 0.9, 0.0], True)):
        zw = torch.tensor([window] * 3, device="cuda")
        if paste:
            zw = invert_where(zw).contiguous()
        w_y, w_x = st_weights(zw[:1], out_shape, in_shape)
        live = (w_y[0] != 0).any(0)[:, None] & (w_x[0] != 0).any(0)[None]
        px = (tuple(live.nonzero()[0].tolist()),
              tuple((~live).nonzero()[0].tolist()))
        # the cotangent at an output pixel with (and one without) a tap
        live_g = (w_y[0] != 0).any(1)[:, None] & (w_x[0] != 0).any(1)[None]
        gx = (tuple(live_g.nonzero()[0].tolist()),
              tuple((~live_g).nonzero()[0].tolist()))
        for value, mode in [(v, m) for v in (float("nan"), float("inf"),
                                             -float("inf"))
                            for m in ("float32", "bfloat16")]:
            for where in ("img", "g") if backward else ("img",):
                img = torch.rand((3,) + in_shape, generator=gen,
                                 device="cuda")
                g = torch.randn((3,) + out_shape, generator=gen,
                                device="cuda")
                t, at = (img, px) if where == "img" else (g, gx)
                t[(0,) + at[0]] = value
                t[(1,) + at[1]] = value
                if backward:
                    k = st_kernel.st_gather_bwd_cuda(img, zw, g, out_shape,
                                                     mode)
                    p = st_kernel.st_gather_bwd_plain(img, zw, g, out_shape,
                                                      mode)
                    alone = st_kernel.st_gather_bwd_cuda(
                        img[2:], zw[2:], g[2:], out_shape, mode)
                    ok = all(same_pattern(a, b) and torch.equal(a[2:], c)
                             for a, b, c in zip(k, p, alone))
                else:
                    k = st_kernel.st_gather_cuda(img, zw, out_shape, mode)
                    p = st_kernel.st_gather_plain(img, zw, out_shape, mode)
                    ok = same_pattern(k, p) and torch.equal(
                        k[2:], st_kernel.st_gather_cuda(img[2:], zw[2:],
                                                        out_shape, mode))
                if not ok:
                    raise AssertionError(
                        f"{'backward' if backward else 'forward'} "
                        f"{in_shape}->{out_shape} {mode}: {value} in {where}"
                        f": not the plain version's NaN/inf pattern")
                cases += 1
    print(f"  non-finite inputs: the plain version's NaN/+-inf pattern in "
          f"{cases} cases (NaN, +inf, -inf at a tapped and an untapped "
          f"pixel{', in img and in g' if backward else ''}; gather and "
          f"paste; f32 and bf16), the finite example's bits kept",
          flush=True)


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
    """The serving path, end to end, through its CUDA graphs."""
    from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
    from attend_infer_repeat_torch.serving import (
        make_generate_fn, make_infer_fn)
    from attend_infer_repeat_torch.utils import debug_mode, graphs

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
    # a graph's first call runs its warm-up eagerly, then replays
    first = 1 + graphs.WARMUP

    st_kernel.launches = st_kernel.bwd_launches = 0
    shapes0 = collections.Counter(st_kernel.shape_launches)
    expected = 0

    def expect(delta, what):
        nonlocal expected
        expected += delta
        if st_kernel.launches != expected:
            raise AssertionError(f"{what}: {st_kernel.launches} launches, "
                                 f"expected {expected}")

    (imgs, nums), dt = timed(synth, N_SERVE, gen)
    expect(first, "synthesis")
    if not (imgs.shape == (N_SERVE, 50, 50) and torch.isfinite(imgs).all()
            and imgs.min() >= 0 and imgs.max() <= 1):
        raise AssertionError("synthesized canvases out of range")
    print(f"  synthesized {N_SERVE} canvases in {dt * 1e3:.1f} ms "
          f"(mean count {nums.float().mean().item():.3f})", flush=True)

    rates = []
    for r in range(4):
        out, dt = timed(infer, imgs, gen)
        expect(per_forward * (first if r == 0 else 1), f"serving request {r}")
        check_infer(out, N_SERVE, cfg.model)
        rates.append(N_SERVE / dt)
        print(f"  serving request {r}: {dt * 1e3:.2f} ms, "
              f"{N_SERVE / dt:.1f} img/s", flush=True)
    wide = torch.cat([imgs, torch.flip(imgs, dims=[2])], 0)
    out, dt = timed(infer_tiled, wide, gen)
    expect((graphs.WARMUP + 2) * per_forward, "tiled request of 16384")
    check_infer(out, 2 * N_SERVE, cfg.model)
    print(f"  tiled request of {2 * N_SERVE} (tile {N_SERVE}): "
          f"{dt * 1e3:.2f} ms", flush=True)
    fast_rates = []
    for r in range(2):
        out, dt = timed(infer_fast, imgs, gen)
        expect(per_forward * (first if r == 0 else 1),
               f"canonical_fast request {r}")
        check_infer(out, N_SERVE, fast.model)
        fast_rates.append(N_SERVE / dt)
        print(f"  canonical_fast request {r}: {dt * 1e3:.2f} ms, "
              f"{N_SERVE / dt:.1f} img/s", flush=True)
    gen_rates = []
    for r in range(2):
        scenes, dt = timed(generate, N_SERVE, gen)
        expect(first if r == 0 else 1, f"generate {r}")
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
    print(f"  main path: {launches} kernel launches ({per_forward} per "
          f"forward of one tile; a graph's first call adds its "
          f"{graphs.WARMUP} warm-up runs)", flush=True)
    fused = (st_kernel.shape_launches - shapes0)[
        (ACC_KEY, N_SERVE, 20, 20, 50, 50)]
    if not fused:
        raise AssertionError("the serving path's graphs launched no fused "
                             "paste at its batch")
    print(f"  fused paste 20x20->50x50 at N={N_SERVE}: {fused} of them "
          f"(graphed infer and generate's scenes aside)", flush=True)
    print(f"  infer img/s at batch {N_SERVE} (serving, requests 1-3 median): "
          f"{statistics.median(rates[1:]):.1f} on {smi}", flush=True)
    print(f"  infer img/s at batch {N_SERVE} (canonical_fast, request 1): "
          f"{fast_rates[1]:.1f} on {smi}", flush=True)
    print(f"  generate img/s at batch {N_SERVE} (call 1): "
          f"{gen_rates[1]:.1f} on {smi}", flush=True)

    # the same request through the plain spatial transformer on the card:
    # eagerly (a replay would not see the swap and run the kernel again)
    noise = model.sample_noise(N_SERVE, gen)
    out_k, dt_k = timed(infer, imgs, noise=noise)
    kernel_fns = st_kernel.st_gather_cuda, st_kernel.st_gather_accumulate_cuda
    st_kernel.st_gather_cuda = st_kernel.st_gather_plain
    st_kernel.st_gather_accumulate_cuda = st_kernel.st_gather_accumulate_plain
    try:
        with debug_mode(nans=False):
            infer(imgs, noise=noise)
            out_p, dt_p = timed(infer, imgs, noise=noise)
    finally:
        st_kernel.st_gather_cuda, st_kernel.st_gather_accumulate_cuda = \
            kernel_fns
    canvas_err = (out_k["canvas"] - out_p["canvas"]).abs().max().item()
    elbo_rel = ((out_k["elbo"] - out_p["elbo"]).abs()
                / out_p["elbo"].abs().clamp(min=1.0)).max().item()
    pres_equal = torch.equal(out_k["presence"], out_p["presence"])
    print(f"  kernel (graphed) vs plain ST (eager) on one request: canvas max "
          f"abs err {canvas_err:.3g}, elbo max rel err {elbo_rel:.3g}, "
          f"presence {'equal' if pres_equal else 'DIFFERS'}; request "
          f"{dt_k * 1e3:.2f} ms with the kernel, {dt_p * 1e3:.2f} ms plain",
          flush=True)
    if not (canvas_err <= 1e-4 and elbo_rel <= 1e-5 and pres_equal):
        raise AssertionError("the slice through the kernel disagrees with "
                             "the plain spatial transformer")


def gather_bwd_work(zw, in_shape, out_shape, need_img):
    """Bytes and FLOP that this gather's backward needs on these ``zw``.

    Reads the whole input and the whole cotangent ``g`` once (a NaN or an
    infinity anywhere in either changes the gradients, as in the dense
    form), ``zw`` read and ``g_zw`` written; ``g_img`` written whole when
    asked for.  FLOP: per nonzero tap pair, the two zw sums take two
    multiply-adds each and ``g_img`` two more.  Also returns the shares
    of the input and of ``g`` that the taps touch (where the sums need
    them).
    """
    touched_in, touched_out, taps = tap_support(zw, in_shape, out_shape)
    n = zw.shape[0]
    n_in = in_shape[0] * in_shape[1]
    nbytes = (4 * n * (n_in + out_shape[0] * out_shape[1]) + 32 * n
              + (4 * n * n_in if need_img else 0))
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
        # SPACE's render paste, both gradients (space_g16, batch 32)
        ("paste bwd 32x32->128x128", 32 * 256 * 4, (32, 32), (128, 128),
         True, True, True),
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
    nonfinite_phase(st_kernel, invert_where, backward=True)
    return rows


def check_metrics(metrics, what):
    bad = [k for k, v in metrics.items()
           if not torch.isfinite(v).all().item()]
    if bad:
        raise AssertionError(f"{what}: metrics not finite: {bad}")


def train_phase(air, st_kernel, smi, bank):
    """canonical_fast train steps at batch 1024, eagerly (``debug_mode``)
    and through the step's CUDA graph from the same state, held bit-equal
    and timed; then one eager ``make_eval_step``.  Returns the eager
    state and its step."""
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.models import modules
    from attend_infer_repeat_torch.utils import debug_mode, graphs

    fast = air.get_config("canonical_fast")
    state = air.create_train_state(fast, seed=0)
    graphed = air.create_train_state(fast, seed=0)
    step = air.make_train_step(fast, state.model, digit_bank=bank)
    graphed_step = air.make_train_step(fast, graphed.model, digit_bank=bank)
    synth = make_synth_fn(fast.data, bank)
    eval_step = air.make_eval_step(fast, state.model)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    n_cells = fast.model.max_steps
    per_step = (1 + 2 * n_cells, 2 * n_cells)     # synthesis + gather/paste
    # the LSTM's forward once a cell, again in remat's recompute
    lstm_per_step = {"fused": 2 * n_cells, "fused_bwd": n_cells}
    warm, timed_steps = 3, 20

    def lstm_launches(steps, extra=0):
        got = modules.lstm_counts - lstm0
        want = {k: steps * v for k, v in lstm_per_step.items()}
        want["fused"] += extra
        if got != want:
            raise AssertionError(f"LSTM launches {dict(got)} after {steps} "
                                 f"steps, expected {want}")

    st_kernel.launches = st_kernel.bwd_launches = 0
    lstm0 = collections.Counter(modules.lstm_counts)
    with debug_mode(nans=False):
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
    lstm_launches(n_steps)
    moved = max((v - start[k]).abs().max().item()
                for k, v in state.model.state_dict().items())
    if not (moved > 0 and state.step == n_steps):
        raise AssertionError("the train steps changed no parameter")
    last = rows[-1]
    print(f"  {n_steps} eager train steps (canonical_fast, batch {N_TRAIN}): "
          f"{per_step[0]} forward and {per_step[1]} backward launches per "
          f"step, LSTM {lstm_per_step}; last loss {last['loss'].item():.1f}, elbo "
          f"{last['elbo'].item():.2f}, grad_norm "
          f"{last['grad_norm'].item():.1f}; parameters moved up to "
          f"{moved:.3g}", flush=True)

    graphed_rows = []
    for i in range(warm):
        graphed, m = graphed_step(graphed)
        graphed_rows.append(m)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed_steps):
        graphed, m = graphed_step(graphed)
        graphed_rows.append(m)
    torch.cuda.synchronize()
    dt_graph = (time.perf_counter() - t) / timed_steps
    want = rows_of(rows[-timed_steps:])
    got = rows_of(graphed_rows[-timed_steps:])
    gap = hold_to_step_limits("graphed single step",
                              *state_gap(graphed, state), rows_gap(got, want))
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    if counts != ((2 * n_steps + graphs.WARMUP) * per_step[0],
                  (2 * n_steps + graphs.WARMUP) * per_step[1]):
        raise AssertionError(f"graphed train steps: launches {counts}")
    lstm_launches(2 * n_steps + graphs.WARMUP)
    (entry,) = graphed_step.graphs.values()
    print(f"  the same {n_steps} steps through make_train_step's CUDA graph "
          f"(capture at the first call, after {graphs.WARMUP} warm-up "
          f"steps): parameters, optimizer state and metrics {gap}; graph "
          f"pool {entry.graph.pool_bytes / 2**20:.1f} MiB", flush=True)
    print(f"  single train step: eager {dt * 1e3:.3f} ms ({N_TRAIN / dt:.1f} "
          f"train img/s), graphed {dt_graph * 1e3:.3f} ms "
          f"({N_TRAIN / dt_graph:.1f} train img/s), {dt / dt_graph:.2f}x; "
          f"mean of {timed_steps} after {warm}, batch {N_TRAIN} on {smi}",
          flush=True)

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = torch.Generator("cuda").manual_seed(2)
    with debug_mode(nans=False):
        imgs, nums = synth(N_TRAIN, gen)
        metrics, out = eval_step(state, imgs, nums, gen)
    check_metrics(metrics, "eval step")
    if not all(torch.equal(v, before[k])
               for k, v in state.model.state_dict().items()):
        raise AssertionError("the eval step changed a parameter")
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    if counts != ((2 * n_steps + graphs.WARMUP) * per_step[0] + 1
                  + 2 * n_cells,
                  (2 * n_steps + graphs.WARMUP) * per_step[1]):
        raise AssertionError(f"eval step: launches {counts}")
    lstm_launches(2 * n_steps + graphs.WARMUP, extra=n_cells)
    print(f"  eval step (eager): count accuracy "
          f"{metrics['count_accuracy_mode'].item():.4f} (mode, random "
          f"weights), parameters unchanged", flush=True)
    return state, step


def rows_of(rows):
    """A list of metric dicts as one dict of stacked rows."""
    return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}


def record_kernel_calls(st_kernel, run):
    """``run()`` eagerly (``utils.debug_mode``: a replay would call no
    wrapper) with every kernel call's inputs recorded; returns the calls
    ``(kind, img, zw, g, out_shape, need_img)`` in order.  A fused paste
    is kind "acc", its glimpse as ``img`` and ``(canvas, z_pres)`` as
    ``g``."""
    from attend_infer_repeat_torch.utils import debug_mode

    calls = []
    kernels = (st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda,
               st_kernel.st_gather_accumulate_cuda)

    def record_fwd(img, zw, out_shape, *args):
        calls.append(("fwd", img.clone(), zw.clone(), None, tuple(out_shape),
                      None))
        return kernels[0](img, zw, out_shape, *args)

    def record_bwd(img, zw, g, out_shape, compute_dtype="float32",
                   need_img=True):
        calls.append(("bwd", img.clone(), zw.clone(), g.clone(),
                      tuple(out_shape), need_img))
        return kernels[1](img, zw, g, out_shape, compute_dtype, need_img)

    def record_acc(canvas, glimpse, zw, z_pres):
        calls.append(("acc", glimpse.clone(), zw.clone(),
                      (canvas.clone(), z_pres.clone()),
                      tuple(canvas.shape[1:]), None))
        return kernels[2](canvas, glimpse, zw, z_pres)

    (st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda,
     st_kernel.st_gather_accumulate_cuda) = record_fwd, record_bwd, record_acc
    try:
        with debug_mode(nans=False):
            run()
    finally:
        (st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda,
         st_kernel.st_gather_accumulate_cuda) = kernels
    torch.cuda.synchronize()
    return calls


STEP_KINDS = {(16, 16): "synth paste", (20, 20): "paste"}


def kernel_call_rows(st_kernel, calls, label, bw, f32_peak, kinds=STEP_KINDS):
    """Each kernel against plain and timed on exactly the inputs of
    ``calls`` (``record_kernel_calls``); returns the forward rows (fused
    pastes among them) and the backward rows in call order, each named
    after ``label`` and its input shape's entry in ``kinds`` (else
    "gather")."""
    rows = {"fwd": [], "bwd": [], "acc": []}
    kernel = {"fwd": "st_gather", "bwd": "st_gather_bwd", "acc": ACC_KEY}
    forward = []
    for kind, img, zw, g, out_shape, need_img in calls:
        n, h, w = img.shape
        what = kinds.get((h, w), "gather")
        what = {"bwd": f"{what} bwd", "acc": f"fused {what}"}.get(kind, what)
        name = (f"{label} {what} "
                f"{h}x{w}->{out_shape[0]}x{out_shape[1]}"
                f"{'' if need_img is not False else ', g_zw only'} "
                f"#{len(rows[kind]) + 1}")
        row = {"case": name, "n": n, "key": (kernel[kind], n, h, w,
                                             *out_shape)}
        if kind == "acc":
            canvas, z_pres = g
            row["case"] += f", {str(canvas.dtype)[6:]} carry"
            msg = check_accumulate(st_kernel, row, canvas, img, zw, z_pres)
            msg += "; " + time_accumulate(st_kernel, row, canvas, img, zw,
                                          z_pres, bw, f32_peak)
        elif kind == "fwd":
            msg = check_gather(st_kernel, row, img, zw, out_shape)
            msg += "; " + time_gather(st_kernel, row, img, zw, out_shape, bw,
                                      f32_peak)
        else:
            msg = check_bwd(st_kernel, row, img, zw, g, out_shape, need_img)
            msg += "; " + time_gather_bwd(st_kernel, row, img, zw, g,
                                          out_shape, need_img, bw, f32_peak)
        print(msg, flush=True)
        rows[kind].append(row)
        if kind != "bwd":
            forward.append(row)
    return forward, rows["bwd"]


def step_kernel_phase(st_kernel, state, step, bw, f32_peak, label="step"):
    """One more train step with every kernel call's inputs recorded, then
    each kernel against plain and timed on exactly those inputs: the
    windows, images and cotangents that the step really gives them.
    Returns the forward and backward rows, in the order of the calls,
    each named after ``label``."""
    calls = record_kernel_calls(st_kernel, lambda: step(state))
    rows = dict(zip(("fwd", "bwd"), kernel_call_rows(
        st_kernel, calls, label, bw, f32_peak)))
    for kind, kind_label in (("fwd", "forward"), ("bwd", "backward")):
        rs = rows[kind]
        print(f"  the {label}'s {len(rs)} {kind_label} launches: kernel "
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
        kernels = (st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda,
                   st_kernel.st_gather_accumulate_cuda)
        st_kernel.st_gather_cuda = st_kernel.st_gather_plain
        st_kernel.st_gather_bwd_cuda = st_kernel.st_gather_bwd_plain
        st_kernel.st_gather_accumulate_cuda = \
            st_kernel.st_gather_accumulate_plain
        try:
            loss_p, g_p = grads()
        finally:
            (st_kernel.st_gather_cuda, st_kernel.st_gather_bwd_cuda,
             st_kernel.st_gather_accumulate_cuda) = kernels
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


def loop_config(air):
    """canonical_fast for ``train()`` to ``LOOP_STEPS`` in K-step chunks
    of half that, with log, eval, save and figure points at each chunk's
    end (phases 7 and 7d)."""
    fast = air.get_config("canonical_fast")
    half = LOOP_STEPS // 2
    # the basin detector runs at step 100 and logs its statistic; the
    # 0.0 threshold keeps random-weight runs from restarting
    return dataclasses.replace(fast, train=dataclasses.replace(
        fast.train, n_iters=LOOP_STEPS, scan_steps=half, log_every=half,
        save_every=half, fig_every=half, eval_batches=2,
        basin_detect_step=half, basin_accuracy_threshold=0.0))


def check_loop_workdir(workdir, what):
    """A ``LOOP_STEPS`` run's JSONL rows, periodic checkpoints and best
    checkpoint; returns its ``best.json``."""
    half = LOOP_STEPS // 2
    check_loop_rows(loop_rows(workdir), half, (half, LOOP_STEPS), what)
    best = json.loads(Path(workdir, "ckpt_best", "best.json").read_text())
    if not Path(workdir, "ckpt_best", str(best["step"]), "state.pt").exists():
        raise AssertionError(f"{what}: best checkpoint missing: {best}")
    ckpts = sorted(int(p.name) for p in Path(workdir, "ckpt").iterdir()
                   if p.name.isdigit())
    if ckpts != [half, LOOP_STEPS]:
        raise AssertionError(f"{what}: checkpoints {ckpts}")
    return best


def run_cli(workdir, *args):
    """``python -m attend_infer_repeat_torch.train --config canonical_fast
    --iters 2`` and ``args`` in a new process; returns its JSONL rows and
    the command's wall."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "attend_infer_repeat_torch.train",
         "--config", "canonical_fast", "--iters", "2", "--workdir", workdir,
         "--no-tensorboard", *args], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t
    if proc.returncode:
        raise AssertionError(f"CLI run failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    rows = loop_rows(workdir)
    check_loop_rows(rows, None, (2,), f"CLI run {' '.join(args)}")
    return rows, dt


def check_resume(air, cfg, state, workdir, **kw):
    """``train()`` to half of ``LOOP_STEPS`` in ``workdir``, then resumed
    to the end: parameters and optimizer state bit-equal to ``state``,
    the uninterrupted run's."""
    half = LOOP_STEPS // 2
    air.train(cfg, workdir=workdir, n_iters=half, **kw)
    again = air.train(cfg, workdir=workdir, **kw)
    a, b = state_arrays(state), state_arrays(again)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or again.step != state.step:
        raise AssertionError(f"resumed run differs from the "
                             f"uninterrupted one in {differ[:5]}")
    check_loop_rows(loop_rows(workdir), half, (half, LOOP_STEPS),
                    "resumed run")
    print(f"  {half} steps, then a resume to {LOOP_STEPS}: parameters "
          f"and optimizer state ({len(a)} tensors) bit-equal to the "
          f"uninterrupted run", flush=True)


def loop_phase(air, st_kernel, smi):
    """``train()`` on canonical_fast at batch 1024; a resumed run against
    an uninterrupted one; then the CLI."""
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    half = LOOP_STEPS // 2
    cfg = loop_config(air)
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
        n_bwd = 6 * (LOOP_STEPS + WARMUP)
        if counts[1] != n_bwd or counts[0] < 7 * (LOOP_STEPS + WARMUP):
            raise AssertionError(f"train(): launches {counts}, expected "
                                 f"{n_bwd} backward and 7 forward a step")
        best = check_loop_workdir(whole, "uninterrupted run")
        print(f"  train() {LOOP_STEPS} steps (canonical_fast, batch "
              f"{N_TRAIN}, K={half}, graphed): {dt:.2f} s wall with 2 "
              f"log/eval/save "
              f"points, the basin statistic and figure attempts; "
              f"{counts[0]} forward and {counts[1]} backward launches; "
              f"best {best} on {smi}", flush=True)

        check_resume(air, cfg, state, resumed, **kw)

        rows, dt = run_cli(os.path.join(tmp, "cli"))
        ev = next(r for r in rows if r["split"] == "eval")
        print(f"  CLI: 2 canonical_fast steps in a new process, {dt:.1f} s "
              f"wall (start-up, build cache hit, 8+8 eval batches, save); "
              f"eval elbo {ev['elbo']:.2f}", flush=True)


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
    then step walls, eager and graphed, with remat ``save_st`` and off."""
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    fast = air.get_config("canonical_fast")
    k_full = fast.train.scan_steps
    per_step = (1 + 2 * fast.model.max_steps, 2 * fast.model.max_steps)
    st_kernel.launches = st_kernel.bwd_launches = 0
    shapes0 = collections.Counter(st_kernel.shape_launches)
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
                expected[i] += n * (WARMUP + 2 * k)
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
    # each cell step's paste is the fused one, graphed and eager alike
    fused = (st_kernel.shape_launches - shapes0)[(ACC_KEY, N_TRAIN, 20, 20,
                                                  50, 50)]
    steps = expected[0] // per_step[0]
    if fused != fast.model.max_steps * steps:
        raise AssertionError(f"graph phase: {fused} fused pastes over "
                             f"{steps} steps")
    print(f"  fused paste 20x20->50x50 at N={N_TRAIN}: {fused} launches, "
          f"{fast.model.max_steps} a step", flush=True)
    on, off = walls["remat save_st"], walls["remat off"]
    print(f"  remat save_st's step-time cost: eager "
          f"{100 * (on['eager_ms'] / off['eager_ms'] - 1):+.1f} %, graphed "
          f"{100 * (on['graph_ms'] / off['graph_ms'] - 1):+.1f} %", flush=True)
    counts = (st_kernel.launches, st_kernel.bwd_launches)
    if list(counts) != expected:
        raise AssertionError(f"graph phase: launches {counts}")


def versus(name, fn, args, seed, batch, smi, cache=None, reps=3):
    """``fn(*args, generator)``: the graph's first call (the capture), then
    ``reps`` graphed and ``reps`` eager calls, timed; the first graphed and
    eager calls from generators in one state must give bit-equal results
    and leave the generators in one state.  ``cache``: the graphs ``fn``
    replays (``fn.graphs`` by default).  Returns the graphed result."""
    from attend_infer_repeat_torch.utils import debug_mode, graphs

    gens = [torch.Generator("cuda").manual_seed(seed) for _ in range(2)]
    got = fn(*args, gens[0])
    with debug_mode(nans=False):
        want = fn(*args, gens[1])
    a, b = graphs.leaves(got), graphs.leaves(want)
    if not (len(a) == len(b) and all(x.dtype == y.dtype
                                     and torch.equal(x, y)
                                     for x, y in zip(a, b))):
        raise AssertionError(f"{name}: graphed and eager results differ")
    if not torch.equal(gens[0].get_state(), gens[1].get_state()):
        raise AssertionError(f"{name}: the generators differ after")
    walls = {"graphed": [], "eager": []}
    for mode in walls:
        with debug_mode(nans=False) if mode == "eager" \
                else contextlib.nullcontext():
            for r in range(reps):
                g = torch.Generator("cuda").manual_seed(seed + 1 + r)
                walls[mode].append(timed(fn, *args, g)[1])
    ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    cache = fn.graphs if cache is None else cache
    pool = sum(e.graph.pool_bytes for e in cache.values())
    print(f"  {name}: graphed and eager bit-equal, generator left in one "
          f"state; wall graphed {ms['graphed']:.3f} ms "
          f"({batch / ms['graphed'] * 1e3:.1f} img/s), eager "
          f"{ms['eager']:.3f} ms ({batch / ms['eager'] * 1e3:.1f} img/s), "
          f"{ms['eager'] / ms['graphed']:.2f}x (medians of {reps}); "
          f"graph pool {pool / 2**20:.1f} MiB; {smi}", flush=True)
    return got


def entry_points_phase(air, st_kernel, smi, bank):
    """The JAX package's other jitted entry points as CUDA graphs, each
    against its eager call (``debug_mode``) at full width, from one
    generator state: serving infer (the ``serving`` preset and the
    ``canonical_fast`` model) and generate at batch 8192, tiled infer at
    16384, synthesis, eval and IWAE at 1024, and the single train step on
    an external host batch.  Results bit-equal and generators left in one
    state; walls of both paths; each graph's memory pool."""
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.eval import make_iwae_eval_step
    from attend_infer_repeat_torch.serving import (
        make_generate_fn, make_infer_fn)
    from attend_infer_repeat_torch.utils import debug_mode

    serving = air.get_config("serving")
    fast = air.get_config("canonical_fast")
    st_kernel.launches = st_kernel.bwd_launches = 0
    reps = 3

    imgs, _ = make_synth_fn(serving.data, bank)(
        N_SERVE, torch.Generator("cuda").manual_seed(7))
    model = air.AIRModel(serving.model, use_baseline=False, seed=0)
    model_fast = air.AIRModel(fast.model, use_baseline=False, seed=1)
    versus(f"infer, serving, batch {N_SERVE}", make_infer_fn(serving, model),
           (imgs,), 10, N_SERVE, smi)
    versus(f"infer, canonical_fast model, batch {N_SERVE}",
           make_infer_fn(fast, model_fast), (imgs,), 11, N_SERVE, smi)
    wide = torch.cat([imgs, torch.flip(imgs, dims=[2])], 0)
    versus(f"tiled infer, batch {2 * N_SERVE}, tile {N_SERVE}",
           make_infer_fn(serving, model, tile=N_SERVE), (wide,), 12,
           2 * N_SERVE, smi)
    versus(f"generate, batch {N_SERVE}", make_generate_fn(serving, model),
           (N_SERVE,), 13, N_SERVE, smi)
    del wide, model, model_fast

    state = air.create_train_state(fast, seed=11)
    synth = make_synth_fn(fast.data, bank)
    imgs, nums = versus(f"synthesis, batch {N_TRAIN}", synth, (N_TRAIN,), 14,
                        N_TRAIN, smi)
    eval_step = air.make_eval_step(fast, state.model)
    versus(f"eval step, batch {N_TRAIN}",
           lambda g: eval_step(state, imgs, nums, g), (), 15, N_TRAIN, smi,
           eval_step.graphs)
    iwae = make_iwae_eval_step(fast, state.model.with_config(
        dataclasses.replace(fast.model, explore_eps=None)), 5)
    versus(f"IWAE step, 5 particles, batch {N_TRAIN}",
           lambda g: iwae(state, imgs, g), (), 16, N_TRAIN, smi,
           iwae.graphs)

    graphed = air.create_train_state(fast, seed=12)
    eager = air.create_train_state(fast, seed=12)
    step = air.make_train_step(fast, graphed.model)
    eager_step = air.make_train_step(fast, eager.model)
    walls = {"graphed": [], "eager": []}
    rows = {"graphed": [], "eager": []}
    for i in range(2 + reps):
        host = tuple(t.cpu() for t in synth(
            N_TRAIN, torch.Generator("cuda").manual_seed(20 + i)))
        (graphed, m), dt = timed(step, graphed, host)
        walls["graphed"].append(dt)
        rows["graphed"].append(m)
        with debug_mode(nans=False):
            (eager, m), dt = timed(eager_step, eager, host)
        walls["eager"].append(dt)
        rows["eager"].append(m)
    gap = hold_to_step_limits("graphed step on a host batch",
                              *state_gap(graphed, eager),
                              rows_gap(rows_of(rows["graphed"]),
                                       rows_of(rows["eager"])))
    ms = {k: statistics.median(v[2:]) * 1e3 for k, v in walls.items()}
    (entry,) = step.graphs.values()
    print(f"  single train step on an external host batch (canonical_fast, "
          f"batch {N_TRAIN}, {2 + reps} steps): parameters, optimizer state "
          f"and metrics {gap}; wall graphed {ms['graphed']:.3f} ms, eager "
          f"{ms['eager']:.3f} ms (medians of {reps}), "
          f"{ms['eager'] / ms['graphed']:.2f}x; graph pool "
          f"{entry.graph.pool_bytes / 2**20:.1f} MiB; {smi}", flush=True)
    del step, eager_step, iwae, eval_step, synth
    torch.cuda.empty_cache()


MESH_CALLS = 5          # phase 7b: calls of each mesh step, the first captures


def graphed_vs_eager(air, name, make, seed, smi, *args):
    """``make(state)``: a mesh step or chunk.  ``MESH_CALLS`` calls of it
    through its CUDA graph and the same calls eagerly (``debug_mode``),
    in turns from one state, bit-equal in parameters, optimizer state,
    step, counts and every metric row; prints both walls per step
    (medians of the calls after the first, which captures) and the
    graphs' pools.  Returns the graphed step, state and metric rows."""
    from attend_infer_repeat_torch.utils import debug_mode

    fast = air.get_config("canonical_fast")
    states = {m: air.create_train_state(fast, seed=seed)
              for m in ("graphed", "eager")}
    fns = {m: make(s) for m, s in states.items()}
    walls = {m: [] for m in states}
    rows = {m: [] for m in states}
    for _ in range(MESH_CALLS):
        for mode in states:
            with debug_mode(nans=False) if mode == "eager" \
                    else contextlib.nullcontext():
                (states[mode], m), dt = timed(fns[mode], states[mode], *args)
            walls[mode].append(dt)
            rows[mode].append({k: v.reshape(-1) for k, v in m.items()})
    got, want = ({k: torch.cat([r[k] for r in rows[m]]) for k in rows[m][0]}
                 for m in ("graphed", "eager"))
    bit_equal(f"graphed {name}", states["graphed"], states["eager"], got,
              want)
    check_metrics(got, f"graphed {name}")
    k = got["loss"].numel() // MESH_CALLS
    ms = {m: statistics.median(w[1:]) / k * 1e3 for m, w in walls.items()}
    pool = sum(g.graph.pool_bytes for g in fns["graphed"].graphs.values())
    print(f"  {name}: {MESH_CALLS} calls of {k} step(s) graphed and eager "
          f"from one state bit-equal (parameters, optimizer state, "
          f"{len(got)} metric rows); step wall graphed "
          f"{ms['graphed']:.3f} ms, eager {ms['eager']:.3f} ms "
          f"({ms['eager'] / ms['graphed']:.2f}x; medians of calls 2-"
          f"{MESH_CALLS}); graph pool {pool / 2**20:.1f} MiB; {smi}",
          flush=True)
    return fns["graphed"], states["graphed"], got


# Phase 5e: SPACE's step at the benchmark configuration's widths and batch.
SPACE_CONFIG = (Path(__file__).resolve().parent / "air_bench" / "configs"
                / "space_g16.json")
SPACE_K = 2


def space_config():
    """``(Config, SpaceConfig)`` of SPACE's benchmark configuration
    (``SPACE_CONFIG``, read as data)."""
    from attend_infer_repeat_torch import configs as c

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    doc = json.loads(SPACE_CONFIG.read_text())["config"]
    sections = {"model": c.ModelConfig, "prior": c.PriorAnnealConfig,
                "train": c.TrainConfig, "data": c.DataConfig}
    cfg = c.Config(name=doc["name"], **{
        k: cls(**{f: tup(v) for f, v in doc[k].items()})
        for k, cls in sections.items()})
    return cfg, c.SpaceConfig(**{k: tup(v) for k, v in doc["space"].items()})


def space_phase(air, st_kernel, smi):
    """SPACE's train step (``space_g16``: 128 × 128 RGB scenes, 256 cells,
    batch 32) through ``make_scan_train_step``: two graphed calls of
    ``SPACE_K`` steps against the same steps run eagerly
    (``debug_mode``) from the same state, bit for bit in the parameters,
    the optimizer state and every metric row; the ST launches by shape a
    step (the synthesis paste, the indexed gather and the render's paste;
    the indexed g_zw and the paste's backward) and ``space_counts``, the
    first graphed call with its warm-ups; step walls."""
    from attend_infer_repeat_torch.data import load_digit_bank
    from attend_infer_repeat_torch.models import space
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    cfg, sc = space_config()
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
    b, cells = cfg.train.batch_size, sc.grid ** 2
    windows, pastes = b * cells * sc.channels, b * cells * (sc.channels + 1)
    side, (gh, gw) = cfg.model.img_size[0], sc.glimpse_size
    per_step = {
        ("st_gather", b * cfg.data.max_digits, *cfg.data.digit_size, side,
         side): 1,
        ("st_gather_indexed", windows, side, side, gh, gw): 1,
        ("st_gather_bwd_indexed", windows, side, side, gh, gw): 1,
        ("st_gather", pastes, gh, gw, side, side): 1,
        ("st_gather_bwd", pastes, gh, gw, side, side): 1}
    counts_per_step = {"cells": b * cells, "glimpses": windows,
                       "components": b * sc.components}

    def launched(fn, state, runs, what):
        shapes0 = collections.Counter(st_kernel.shape_launches)
        counts0 = collections.Counter(space.space_counts)
        out, dt = timed(fn, state)
        got = +(st_kernel.shape_launches - shapes0)
        if got != {k: runs * v for k, v in per_step.items()}:
            raise AssertionError(f"SPACE {what}: ST launches {dict(got)}, "
                                 f"expected {runs} x {per_step}")
        got = +(space.space_counts - counts0)
        if got != {k: runs * v for k, v in counts_per_step.items()}:
            raise AssertionError(f"SPACE {what}: space_counts {dict(got)}, "
                                 f"expected {runs} x {counts_per_step}")
        return out, dt

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graphed = air.create_train_state(cfg, seed=0, space=sc)
    eager = air.create_train_state(cfg, seed=0, space=sc)
    scan = air.make_scan_train_step(cfg, graphed.model, bank, SPACE_K)
    eager_scan = air.make_scan_train_step(cfg, eager.model, bank, SPACE_K)
    walls = []
    for call, runs in enumerate((WARMUP + SPACE_K, SPACE_K)):
        (graphed, rows), dt_graphed = launched(scan, graphed, runs,
                                               f"graphed call {call}")
        with debug_mode(nans=False):
            (eager, want), dt_eager = launched(eager_scan, eager, SPACE_K,
                                               f"eager call {call}")
        n_differ, worst, err = state_gap(graphed, eager)
        gaps = rows_gap(rows, want)
        if n_differ or any(gaps.values()) or graphed.step != eager.step:
            raise AssertionError(f"SPACE graphed call {call}: {n_differ} "
                                 f"tensors differ from eager (worst {worst}: "
                                 f"rel L2 {err:.3g}), rows {gaps}")
        check_metrics(rows, f"SPACE graphed call {call}")
        walls.append((dt_graphed, dt_eager))
    peak = torch.cuda.max_memory_allocated()
    (dt_graphed, dt_eager), (dt_capture, _) = walls[1], walls[0]
    print(f"  SPACE {cfg.name} batch {b}: 2 graphed calls of {SPACE_K} steps "
          f"bit-equal to eager (parameters, optimizer state, rows); ST "
          f"launches a step {sorted(per_step)}; space_counts a step "
          f"{counts_per_step}; first call (warm-ups, capture) "
          f"{dt_capture:.2f} s; a step graphed {dt_graphed / SPACE_K * 1e3:.1f}"
          f" ms, eager {dt_eager / SPACE_K * 1e3:.1f} ms; peak "
          f"{peak / 2 ** 30:.1f} GiB; loss {rows['loss'][-1].item():.1f}; "
          f"{smi}", flush=True)
    del scan, eager_scan, graphed, eager
    gc.collect()
    torch.cuda.empty_cache()


def mesh_phase(air, st_kernel, bank, smi):
    """Data parallelism on a one-rank NCCL mesh.  First eagerly, the
    reference: the mesh step and the external-batch shard-map step
    against the plain step from the same state, and a per-rank shard-map
    step.  Then every mesh entry point through its CUDA graph, which holds
    its collectives, against its eager call (``graphed_vs_eager``,
    ``versus``), bit-equal: the mesh step (the graphed plain step held to
    it within the step limits, and both timed in turns), the external-
    batch and per-rank shard-map steps, the K = 4 chunk, sharded infer
    (one pass and tiled) and generate at batch 8192."""
    import torch.distributed as dist
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.parallel import (
        make_mesh, make_shardmap_train_step)
    from attend_infer_repeat_torch.serving import (
        make_generate_fn, make_infer_fn)
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    fast = air.get_config("canonical_fast")
    serving = air.get_config("serving")
    mesh = make_mesh()
    print(f"  mesh {mesh} on the {dist.get_backend()} backend", flush=True)
    st_kernel.launches = st_kernel.bwd_launches = 0
    try:
        # eagerly, the reference: the one-device steps too
        with debug_mode(nans=False):
            plain = air.create_train_state(fast, seed=6)
            meshed = air.create_train_state(fast, seed=6)
            plain, mp = air.make_train_step(fast, plain.model,
                                            digit_bank=bank)(plain)
            meshed, mm = air.make_train_step(
                fast, meshed.model, digit_bank=bank, mesh=mesh)(meshed)
            gap = hold_to_step_limits("mesh step", *state_gap(meshed, plain),
                                      rows_gap(mm, mp))
            print(f"  eager mesh step vs plain step: {gap}", flush=True)

            imgs, nums = make_synth_fn(fast.data, bank)(
                N_TRAIN, torch.Generator("cuda").manual_seed(5))
            imgs = imgs.clone()
            a = air.create_train_state(fast, seed=7)
            b = air.create_train_state(fast, seed=7)
            a, ma = air.make_train_step(fast, a.model)(a, (imgs, nums))
            b, mb = make_shardmap_train_step(
                fast, b.model, bank, mesh, external_batch=True)(
                    b, (imgs, nums))
            gap = hold_to_step_limits("shard-map step", *state_gap(b, a),
                                      rows_gap(mb, ma))
            print(f"  eager external-batch shard-map step vs plain step on "
                  f"one batch: {gap}", flush=True)
            c = air.create_train_state(fast, seed=8)
            step = make_shardmap_train_step(fast, c.model, bank, mesh)
            for _ in range(2):
                c, mc = step(c)
                check_metrics(mc, "per-rank shard-map step")
            print(f"  eager per-rank shard-map step: 2 steps, elbo "
                  f"{mc['elbo'].item():.2f}", flush=True)
        del plain, meshed, a, b, c, step
        # 6 steps, 2 of them on an injected batch (no synthesis), and the
        # synthesis of that batch
        expected = [6 * 7 - 2 + 1, 6 * 6]
        counts = [st_kernel.launches, st_kernel.bwd_launches]
        if counts != expected:
            raise AssertionError(f"eager mesh steps: launches {counts}")

        # through the CUDA graphs: graphed runs = warm-up + calls x steps
        def add(per_run, runs):
            for i, n in enumerate(per_run):
                expected[i] += n * runs

        graphed_runs = WARMUP + MESH_CALLS
        step, meshed, mesh_rows = graphed_vs_eager(
            air, "mesh step", lambda s: air.make_train_step(
                fast, s.model, digit_bank=bank, mesh=mesh), 21, smi)
        add((7, 6), graphed_runs + MESH_CALLS)
        plain = air.create_train_state(fast, seed=21)
        plain_step = air.make_train_step(fast, plain.model, digit_bank=bank)
        rows = []
        for _ in range(MESH_CALLS):
            plain, m = plain_step(plain)
            rows.append(m)
        add((7, 6), graphed_runs)
        gap = hold_to_step_limits("graphed mesh step vs graphed plain step",
                                  *state_gap(meshed, plain),
                                  rows_gap(mesh_rows, rows_of(rows)))
        walls = {"mesh": [], "plain": []}
        for _ in range(10):
            walls["mesh"].append(timed(step, meshed)[1])
            walls["plain"].append(timed(plain_step, plain)[1])
        add((7, 6), 2 * 10)
        ms = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
        print(f"  graphed mesh step vs graphed plain step, {MESH_CALLS} "
              f"steps from one state: {gap}; step wall in turns (medians of "
              f"10): mesh {ms['mesh']:.3f} ms, plain {ms['plain']:.3f} ms "
              f"({100 * (ms['mesh'] / ms['plain'] - 1):+.1f} %), batch "
              f"{N_TRAIN} on {smi}", flush=True)
        del step, plain_step, meshed, plain

        graphed_vs_eager(air, "external-batch shard-map step",
                         lambda s: make_shardmap_train_step(
                             fast, s.model, bank, mesh, external_batch=True),
                         22, smi, (imgs, nums))
        add((6, 6), graphed_runs + MESH_CALLS)
        graphed_vs_eager(air, "per-rank shard-map step",
                         lambda s: make_shardmap_train_step(
                             fast, s.model, bank, mesh), 23, smi)
        add((7, 6), graphed_runs + MESH_CALLS)
        k = 4
        graphed_vs_eager(air, f"mesh chunk K={k}",
                         lambda s: air.make_scan_train_step(
                             fast, s.model, bank, k, mesh=mesh), 24, smi)
        add((7, 6), WARMUP + 2 * k * MESH_CALLS)
        del imgs, nums
        torch.cuda.empty_cache()

        reps = 3
        runs = WARMUP + 2 + 2 * reps                # as ``versus`` calls
        model = air.AIRModel(serving.model, use_baseline=False, seed=0)
        with debug_mode(nans=False):
            imgs, _ = make_synth_fn(serving.data, bank)(
                N_SERVE, torch.Generator("cuda").manual_seed(7))
        add((1, 0), 1)
        out = versus(f"sharded infer, serving, batch {N_SERVE}",
                     make_infer_fn(serving, model, mesh=mesh), (imgs,), 30,
                     N_SERVE, smi, reps=reps)
        check_infer(out, N_SERVE, serving.model)
        versus(f"sharded infer, serving, batch {N_SERVE}, tile "
               f"{N_SERVE // 2}", make_infer_fn(
                   serving, model, tile=N_SERVE // 2, mesh=mesh), (imgs,),
               31, N_SERVE, smi, reps=reps)
        add((2 * 2 * serving.model.max_steps, 0), runs)
        versus(f"sharded generate, batch {N_SERVE}",
               make_generate_fn(serving, model, mesh=mesh), (N_SERVE,), 32,
               N_SERVE, smi, reps=reps)
        add((1, 0), runs)
        del model, imgs, out
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    counts = [st_kernel.launches, st_kernel.bwd_launches]
    if counts != expected:
        raise AssertionError(f"mesh phase: launches {counts}, expected "
                             f"{expected}")
    print(f"  mesh phase launches: {counts[0]} forward, {counts[1]} backward "
          f"(a graph's first call adds its {WARMUP} warm-up runs); {smi}",
          flush=True)


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


# Phase 7d: the reference workflow through the scripts' own main(argv).
TOOLS = ("torch_create_dataset", "torch_eval_checkpoint",
         "torch_run_variant", "torch_make_explainaway_fig")
EVAL_BATCHES = 16       # phase 7d: the evaluator's held-out batches
STREAM_STEPS = 50       # phase 7d: train() on the host-streamed pickle
PACE_STEPS = 20         # phase 7d: steps per reading of the streamed pace
# what the JAX evaluator (scripts/eval_checkpoint.py) prints of evaluate()'s
# and of the IWAE step's metrics
EVAL_KEYS = ["count_accuracy", "count_accuracy_mode", "elbo", "kl_steps"]
IWAE_KEYS = ["elbo", "iwae_bound", "iwae_gap", "log_w_mean", "n_particles"]


def load_tool(name):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_pickle(path, n, canvas, counts):
    """A written pickle: the reference's keys, dtypes and shapes, counts in
    ``counts``, pixels finite in [0, 1]; returns its arrays."""
    import pickle

    import numpy as np

    with open(path, "rb") as f:
        blob = pickle.load(f)
    if sorted(blob) != ["imgs", "nums"]:
        raise AssertionError(f"{path}: keys {sorted(blob)}")
    imgs, nums = blob["imgs"], blob["nums"]
    if imgs.dtype != np.float32 or imgs.shape != (n, canvas, canvas) or \
            nums.dtype != np.int32 or nums.shape != (n,):
        raise AssertionError(f"{path}: imgs {imgs.dtype} {imgs.shape}, "
                             f"nums {nums.dtype} {nums.shape}")
    if not (counts[0] <= nums.min() and nums.max() <= counts[1]):
        raise AssertionError(f"{path}: counts {nums.min()}..{nums.max()}")
    if not (np.isfinite(imgs).all() and imgs.min() >= 0.0
            and imgs.max() <= 1.0):
        raise AssertionError(f"{path}: pixels not finite in [0, 1]")
    return imgs, nums


def host_ms(fn, n):
    """Mean wall of ``fn()`` over ``n`` calls, the card synchronized
    before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def workflow_phase(air, st_kernel, smi, bank):
    """The reference workflow, in process through each script's
    ``main(argv)`` at ``canonical_fast``'s batch of 1024: write the
    dataset pickles at their defaults; ``train()`` from them, resident
    (with a bit-equal resume) and streamed; the CLI with ``--data``; the
    evaluator (latest with ``--iwae``, and ``--best``); the override
    runner; the explain-away selection."""
    from attend_infer_repeat_torch.data import load_data
    from attend_infer_repeat_torch.data.loader import InMemoryDataset
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    tools = {name: load_tool(name) for name in TOOLS}
    fast = air.get_config("canonical_fast")
    cfg = loop_config(air)
    half = LOOP_STEPS // 2
    steps_fwd, steps_bwd = 2 * fast.model.max_steps, 2 * fast.model.max_steps
    total = [0, 0]

    def take():
        """The launches since the last call, added to the phase's."""
        counts = (st_kernel.launches, st_kernel.bwd_launches)
        total[0] += counts[0]
        total[1] += counts[1]
        st_kernel.launches = st_kernel.bwd_launches = 0
        return counts

    t_phase = time.perf_counter()
    st_kernel.launches = st_kernel.bwd_launches = 0
    with tempfile.TemporaryDirectory(prefix="air_workflow_") as tmp:
        # (a) the dataset writer at its defaults: one synthesis graph per
        # split, a replay (one paste launch) per chunk of 4096
        data = os.path.join(tmp, "data")
        written, dt = timed(tools["torch_create_dataset"].main,
                            ["--outdir", data])
        calls = math.ceil(60_000 / 4096) + math.ceil(10_000 / 4096)
        counts = take()
        if counts != (calls + 2 * WARMUP, 0):
            raise AssertionError(f"dataset writer: launches {counts}, "
                                 f"expected {calls} calls and the 2 "
                                 f"graphs' {2 * WARMUP} warm-up runs")
        train_pk = written["mnist_train"]["path"]
        val_pk = written["mnist_validation"]["path"]
        train_imgs, _ = check_pickle(train_pk, 60_000, 50, (0, 2))
        val_imgs, _ = check_pickle(val_pk, 10_000, 50, (0, 2))
        print(f"  dataset writer (60,000 + 10,000 canvases 50x50, 0-2 "
              f"digits, chunk 4096): {dt:.2f} s wall; {calls} synthesis "
              f"calls, {counts[0]} paste launches ({2 * WARMUP} of them "
              f"the 2 graphs' warm-ups); mnist_train.pickle "
              f"{os.path.getsize(train_pk) / 1e6:.1f} MB, count histogram "
              f"{written['mnist_train']['histogram']}; "
              f"mnist_validation.pickle {os.path.getsize(val_pk) / 1e6:.1f} "
              f"MB, {written['mnist_validation']['histogram']}", flush=True)
        again = os.path.join(tmp, "again")
        tools["torch_create_dataset"].main(["--outdir", again,
                                            "--n-train", "4096"])
        take()
        re_train, _ = check_pickle(os.path.join(again, "mnist_train.pickle"),
                                   4096, 50, (0, 2))
        re_val, _ = check_pickle(
            os.path.join(again, "mnist_validation.pickle"), 10_000, 50,
            (0, 2))
        if re_val.tobytes() != val_imgs.tobytes() or \
                re_train.tobytes() != train_imgs[:4096].tobytes():
            raise AssertionError("a second write with the same seed differs")
        print("  a second write with the same --seed: the validation "
              "split and the first train chunk byte-equal", flush=True)
        del train_imgs, val_imgs, re_train, re_val

        # (b) train() from the pickles, resident: the phase 7 schedule
        kw = dict(use_tensorboard=False, data_path=train_pk,
                  eval_data_path=val_pk)
        whole = os.path.join(tmp, "whole")
        state, dt = timed(air.train, cfg, workdir=whole, **kw)
        counts = take()
        # one chunk graph: 6 forward and 6 backward launches a step (no
        # synthesis paste), the log points' forwards on top
        n_steps = LOOP_STEPS + WARMUP
        if state.step != LOOP_STEPS or counts[1] != steps_bwd * n_steps or \
                counts[0] < steps_fwd * n_steps:
            raise AssertionError(f"resident train(): step {state.step}, "
                                 f"launches {counts}")
        best = check_loop_workdir(whole, "resident run")
        print(f"  train() from the pickles, resident, {LOOP_STEPS} steps "
              f"(K={half}): {dt:.2f} s wall (the pickles' load and the "
              f"dataset's copy to the card included); {counts[0]} forward "
              f"and {counts[1]} backward launches; best {best}", flush=True)
        check_resume(air, cfg, state, os.path.join(tmp, "res"), **kw)
        take()

        # steady wall per step: the resident chunk against the
        # synthesis-fed one (phase 7's data), in turns
        blob = load_data(train_pk)
        device_data = (torch.from_numpy(blob["imgs"]).cuda(),
                       torch.from_numpy(blob["nums"]).cuda())
        k = fast.train.scan_steps
        chunks, walls = {}, {"resident": [], "synthesis": []}
        for name in walls:
            st = air.create_train_state(fast, seed=11)
            scan = air.make_scan_train_step(
                fast, st.model, None if name == "resident" else bank, k,
                device_data=device_data if name == "resident" else None)
            scan(st)                        # capture, then K replays
            chunks[name] = (st, scan)
        for name in ("synthesis", "resident", "resident", "synthesis") * 2:
            st, scan = chunks[name]
            (_, rows), dt = timed(scan, st)
            check_metrics(rows, f"{name} chunk")
            walls[name].append(dt / k * 1e3)
        counts = take()
        n_steps = WARMUP + 5 * k
        want = ((steps_fwd + 1) * n_steps + steps_fwd * n_steps,
                2 * steps_bwd * n_steps)
        if counts != want:
            raise AssertionError(f"chunks in turns: launches {counts}, "
                                 f"expected {want}")
        res, syn = (statistics.median(walls[n])
                    for n in ("resident", "synthesis"))
        print(f"  steady step wall, graphed chunks of {k} in turns "
              f"(medians of 4): resident pickle {res:.3f} ms "
              f"({', '.join(f'{w:.3f}' for w in walls['resident'])}), "
              f"synthesis-fed {syn:.3f} ms "
              f"({', '.join(f'{w:.3f}' for w in walls['synthesis'])}); "
              f"resident / synthesis {res / syn:.3f}; batch {N_TRAIN} on "
              f"{smi}", flush=True)
        del chunks, device_data

        # (c) train() streamed: a host batch copied in per step
        streamed = os.path.join(tmp, "streamed")
        state, dt = timed(air.train, cfg, workdir=streamed,
                          n_iters=STREAM_STEPS, resident_data=False, **kw)
        counts = take()
        n_steps = STREAM_STEPS + WARMUP
        if state.step != STREAM_STEPS or counts[1] != steps_bwd * n_steps:
            raise AssertionError(f"streamed train(): step {state.step}, "
                                 f"launches {counts}")
        check_loop_rows(loop_rows(streamed), half,
                        sorted({*range(half, STREAM_STEPS, half),
                                STREAM_STEPS}), "streamed run")
        print(f"  train() streamed, {STREAM_STEPS} steps: {dt:.2f} s wall "
              f"({dt / STREAM_STEPS * 1e3:.1f} ms a step with the "
              f"pickles' load, the capture and a log point); {counts[0]} "
              f"forward and {counts[1]} backward launches", flush=True)
        # what sets the streamed pace: the host's batch assembly, the
        # copy of 1024 x 50 x 50 x 4 B to the card, or the step's graph
        batches = InMemoryDataset(blob["imgs"], blob["nums"]).batches(
            N_TRAIN, seed=5)
        st = air.create_train_state(fast, seed=12)
        step = air.make_train_step(fast, st.model)
        host = tuple(torch.from_numpy(a) for a in next(batches))
        on_card = tuple(t.cuda() for t in host)
        step(st, on_card)                   # capture
        assembly = host_ms(lambda: next(batches), PACE_STEPS)
        buf = torch.empty_like(on_card[0])
        copy = host_ms(lambda: buf.copy_(host[0].pin_memory(),
                                         non_blocking=True), PACE_STEPS)
        graph = host_ms(lambda: step(st, on_card), PACE_STEPS)
        whole_step = host_ms(lambda: step(st, next(batches)), PACE_STEPS)
        take()
        parts = {"the host's batch assembly": assembly,
                 "the copy to the card (pinning included)": copy,
                 "the step's graph": graph}
        pace = max(parts, key=parts.get)
        print(f"  streamed pace, means of {PACE_STEPS}: a streamed step "
              f"{whole_step:.3f} ms; its parts alone: batch assembly "
              f"(numpy gather of {N_TRAIN} rows) {assembly:.3f} ms, pinned "
              f"copy of {host[0].numel() * 4 / 1e6:.2f} MB {copy:.3f} ms, "
              f"the graph on a batch already on the card {graph:.3f} ms: "
              f"{pace} sets the pace", flush=True)
        del blob, batches, host, on_card, buf

        # (d) the CLI on the pickles, in a new process
        rows, dt = run_cli(os.path.join(tmp, "cli"), "--data", train_pk,
                           "--eval-data", val_pk)
        print(f"  CLI --data/--eval-data: 2 steps in a new process, "
              f"{dt:.1f} s wall; eval elbo "
              f"{next(r for r in rows if r['split'] == 'eval')['elbo']:.2f}",
              flush=True)

        # (e) the evaluator on (b)'s run: latest with --iwae, then --best
        evaluator = tools["torch_eval_checkpoint"]
        for extra, step_no in ((["--iwae"], LOOP_STEPS),
                               (["--best"], best["step"])):
            out, dt = timed(evaluator.main, [
                "--config", "canonical_fast", "--workdir", whole,
                "--batches", str(EVAL_BATCHES), *extra])
            counts = take()
            iwae = "--iwae" in extra
            # a graph per entry point: its warm-up runs, then a replay a
            # call (synthesis: one paste; eval, IWAE: a forward)
            want = (EVAL_BATCHES + iwae + WARMUP
                    + steps_fwd * (2 * EVAL_BATCHES + WARMUP)
                    + steps_fwd * (WARMUP + 1) * iwae, 0)
            total_n = int(out["confusion"]["confusion"].sum())
            shown = {**out["eval"], **(out["iwae"] or {})}
            if out["restored_step"] != step_no or \
                    total_n != EVAL_BATCHES * N_TRAIN or \
                    sorted(out["eval"]) != EVAL_KEYS or \
                    (iwae and sorted(out["iwae"]) != IWAE_KEYS) or \
                    not all(math.isfinite(v) for v in shown.values()) or \
                    counts != want:
                raise AssertionError(
                    f"evaluator {extra}: step {out['restored_step']} "
                    f"(expected {step_no}), confusion total {total_n}, "
                    f"keys {sorted(shown)}, launches {counts} (expected "
                    f"{want})")
            sec = out["seconds"]
            print(f"  evaluator {' '.join(extra)}: restored step "
                  f"{step_no}, confusion total {total_n}, {dt:.2f} s "
                  f"wall; eval pass {sec['evaluate']:.3f} s "
                  f"({EVAL_BATCHES * N_TRAIN / sec['evaluate']:.1f} img/s), "
                  f"confusion pass {sec['confusion']:.3f} s"
                  + (f", IWAE {sec['iwae']:.3f} s" if iwae else "")
                  + f"; {counts[0]} forward launches", flush=True)

        # (f) the override runner
        variant = os.path.join(tmp, "variant")
        state, dt = timed(tools["torch_run_variant"].main, [
            "--config", "canonical_fast", "--workdir", variant,
            "--model-set", "remat=False", "--train-set", "scan_steps=50",
            "--iters", "100"])
        counts = take()
        if state.step != 100 or state.model.cfg.remat is not False or \
                counts[1] != steps_bwd * (100 + WARMUP):
            raise AssertionError(f"override runner: step {state.step}, "
                                 f"remat {state.model.cfg.remat}, "
                                 f"launches {counts}")
        check_loop_rows(loop_rows(variant), None, (100,), "override runner")
        print(f"  override runner (remat=False, scan_steps=50, 100 steps): "
              f"{dt:.2f} s wall, remat {state.model.cfg.remat}; "
              f"{counts[0]} forward and {counts[1]} backward launches",
              flush=True)

        # (g) the explain-away selection on (b)'s checkpoint
        figure = tools["torch_make_explainaway_fig"]
        args = figure.parse_args(["--config", "canonical_fast",
                                  "--workdir", whole, "--out",
                                  os.path.join(tmp, "explain_away.png")])
        scenes = figure.find_scenes(args)
        take()
        if scenes["restored_step"] != LOOP_STEPS:
            raise AssertionError(f"explain-away: restored step "
                                 f"{scenes['restored_step']}")
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            try:
                figure.render(scenes, args.out)
            except ImportError as e:
                rendered = f"render raised ImportError ({e})"
            else:
                raise AssertionError("the render did not raise without "
                                     "matplotlib")
        else:
            rendered = "render not held: matplotlib is installed"
            if len(scenes["sel"]):
                rendered = f"rendered {figure.render(scenes, args.out)}"
        print(f"  explain-away: {len(scenes['sel'])} scenes of "
              f"{args.batch} selected (IoU >= {args.min_iou}); {rendered}",
              flush=True)
    print(f"  phase 7d: {time.perf_counter() - t_phase:.1f} s wall; "
          f"{total[0]} forward and {total[1]} backward launches",
          flush=True)


# Phase 7e: the analysis tools through their main(argv).
ANALYSIS_STEPS = 200    # phase 7e: train() of the tools' checkpoints
CEILING_STEPS = 200     # phase 7e: the supervised ceiling's train steps
GRAPH_CHECK_STEPS = 4   # phase 7e: CountCNN steps graphed against eager
VARIANT_STEPS = 20      # phase 7e: the ablation and probe runs
# phase 7e: the CPU against the card holds the limits of the kernel path
# against the plain ST (phase 4): canvas max abs err, ELBO max rel err
PARITY_LIMITS = (1e-4, 1e-5)
# the synthesis pastes that phase 7e times (tool 2's chunk of 8192 canvases
# of each uniform preset): the preset and its digits' input shape
SYNTH_ROWS = {"canonical_uniform": (20, 20), "canonical_uniform28": (28, 28)}


def shapes_text(counter):
    """``st_kernel.shape_launches`` (or a part of it) as short text."""
    return ", ".join(f"{'bwd ' if k == 'st_gather_bwd' else ''}{h}x{w}->"
                     f"{oh}x{ow} N={n}: {c}"
                     for (k, n, h, w, oh, ow), c in sorted(counter.items()))


def parity_gap(outs):
    """The CPU against the card (``torch_parity_check.parity``'s outputs)
    on the examples whose presence agrees: canvas max abs err and ELBO
    max rel err (``|card - cpu| / max(1, |cpu|)``, as phase 4 measures
    the kernel against the plain ST)."""
    import numpy as np

    cpu, dev = outs["cpu"], outs["device"]
    match = (cpu["pres"] == dev["pres"]).all(axis=-1)
    canvas = float(np.max(np.abs(dev["canvas"] - cpu["canvas"])[match],
                          initial=0.0))
    elbo = float(np.max((np.abs(dev["elbo"] - cpu["elbo"])
                         / np.maximum(np.abs(cpu["elbo"]), 1.0))[match],
                        initial=0.0))
    return canvas, elbo


def f32_gaps(parity, air, cfg, outs, batch):
    """``parity_gap`` of the same forward computed in f32 on the CPU (bf16
    compute and canvas carry off) against the CPU's and against the card's
    bf16 forward (``outs``): how far bf16 rounding moves each device's
    outputs."""
    model, imgs, noise = parity.parity_inputs(cfg, batch)
    f32 = air.AIRModel(dataclasses.replace(
        cfg.model, dtype="float32", canvas_carry_dtype="float32"),
        device="cpu", seed=0)
    f32.load_state_dict(model.state_dict())
    ref = parity.forward_outputs(f32, imgs, noise)
    return (parity_gap({"cpu": ref, "device": outs["cpu"]}),
            parity_gap({"cpu": ref, "device": outs["device"]}))


def ceiling_graph_check(tool, air, bank):
    """``CountCNN``'s train step graphed against the same steps eager
    (``utils.debug_mode``) from one initialization and one generator
    state, and graphed ``predict`` against eager: bit-equal parameters,
    optimizer state, losses, accuracies, generator state and counts."""
    from attend_infer_repeat_torch.utils import debug_mode

    cfg = air.get_config("canonical_uniform28")
    gen = torch.Generator("cuda").manual_seed(7)
    start = gen.get_state()
    runs = {}
    for name in ("graphed", "eager"):
        gen.set_state(start)
        model = tool.CountCNN(cfg.data.max_digits + 1, seed=3)
        opt = tool.make_optimizer(model, 3e-4)
        step = tool.make_train_step(model, opt, cfg.data, bank, 512)
        with debug_mode(nans=False) if name == "eager" else \
                contextlib.nullcontext():
            rows = [step(gen) for _ in range(GRAPH_CHECK_STEPS)]
        runs[name] = (model, tool.optimizer_tensors(opt), rows,
                      gen.get_state(), step)
    (m_g, o_g, r_g, s_g, step_g), (m_e, o_e, r_e, s_e, _) = (
        runs["graphed"], runs["eager"])
    differ = [k for (k, a), b in zip(m_g.state_dict().items(),
                                     m_e.state_dict().values())
              if not torch.equal(a, b)]
    differ += [f"optimizer state {i}" for i, (a, b) in enumerate(zip(o_g, o_e))
               if not torch.equal(a, b)]
    differ += [f"step {i} {what}" for i, (a, b) in enumerate(zip(r_g, r_e))
               for what, x, y in zip(("loss", "accuracy"), a, b)
               if not torch.equal(x, y)]
    if not torch.equal(s_g, s_e):
        differ.append("generator state")
    imgs = air.synthesize_batch(bank, cfg.data, 1024, gen)[0]
    predict = tool.make_predict(m_g)
    graphed = [predict(imgs) for _ in range(2)]
    with debug_mode(nans=False):
        eager = predict(imgs)
    if not all(torch.equal(g, eager) for g in graphed):
        differ.append("predict")
    if differ:
        raise AssertionError(f"CountCNN graphed against eager: {differ}")
    pools = step_g.graph().pool_bytes + sum(
        e.graph.pool_bytes for e in predict.graphs.values())
    print(f"  CountCNN: {GRAPH_CHECK_STEPS} train steps at batch 512 "
          f"graphed and eager from one state and generator state, "
          f"bit-equal (parameters, Adam state, losses {float(r_g[-1][0]):.4f}"
          f", generator); predict at 1024 bit-equal; graph pools "
          f"{pools / 2**20:.1f} MiB", flush=True)


def analysis_phase(air, st_kernel, smi, bw, f32_peak):
    """The analysis tools in process through each script's ``main(argv)``,
    in a temporary directory: ``train()`` of ``canonical_uniform28`` and
    ``iwae`` to ``ANALYSIS_STEPS``; the overlap characterization at its
    defaults; the overlap-error bins on the u28 checkpoint; the supervised
    ceiling (its graphs held to eager first); the IWAE k-sweep at k = 1, 5,
    25 and 64; the CPU↔card parity check at ``canonical`` batch 16, held
    to ``PARITY_LIMITS``, and at ``canonical_fast`` batch 1024, reported
    beside each device's distance from the f32 forward; one ablation and
    one probe variant.  Then both kernels against plain and timed on
    the IWAE forward's inputs at k = 25 and 64 and on the uniform presets'
    synthesis pastes.  Returns the phase's launches by shape and the
    timed rows."""
    from attend_infer_repeat_torch.data import load_digit_bank
    from attend_infer_repeat_torch.ops.math import seeded_generator

    tools = {name: load_tool(f"torch_{name}") for name in (
        "characterize_overlap", "analyze_overlap_errors",
        "supervised_ceiling", "iwae_ksweep", "parity_check",
        "ablate_canonical", "probe_u28")}
    total = [0, 0]
    st_kernel.shape_launches.clear()

    def run(what, fn, *args, **kw):
        """``fn`` timed, with its launches by shape printed and added."""
        before = collections.Counter(st_kernel.shape_launches)
        counts = (st_kernel.launches, st_kernel.bwd_launches)
        out, dt = timed(fn, *args, **kw)
        fwd = st_kernel.launches - counts[0]
        bwd = st_kernel.bwd_launches - counts[1]
        total[0] += fwd
        total[1] += bwd
        shapes = shapes_text(st_kernel.shape_launches - before)
        print(f"  {what}: {dt:.2f} s wall; {fwd} forward and {bwd} "
              f"backward launches ({shapes})", flush=True)
        return out

    t_phase = time.perf_counter()
    st_kernel.launches = st_kernel.bwd_launches = 0
    with tempfile.TemporaryDirectory(prefix="air_analysis_") as tmp:
        workdirs = {}
        for name in ("canonical_uniform28", "iwae"):
            workdirs[name] = os.path.join(tmp, name)
            state = run(f"train() {name} to {ANALYSIS_STEPS}", air.train,
                        name, workdir=workdirs[name], n_iters=ANALYSIS_STEPS,
                        use_tensorboard=False)
            if state.step != ANALYSIS_STEPS:
                raise AssertionError(f"{name}: step {state.step}")

        rows = run("overlap characterization (3 presets, n = 65,536)",
                   tools["characterize_overlap"].main,
                   ["--out", os.path.join(tmp, "overlap.json")])
        if [r["n_scenes"] for r in rows] != [65536] * 3 or \
                not all(r["n_multi_scenes"] > 0 for r in rows):
            raise AssertionError(f"overlap characterization: {rows}")

        out = run("overlap errors (canonical_uniform28, 16 x 1024)",
                  tools["analyze_overlap_errors"].main,
                  ["--workdir", workdirs["canonical_uniform28"], "--out",
                   os.path.join(tmp, "errors.json")])
        if out["step"] != ANALYSIS_STEPS or out["n_scenes"] != 16 * 1024 or \
                sum(r["n_scenes"] for r in out["bins"]) != 16 * 1024:
            raise AssertionError(f"overlap errors: {out}")

        ceiling = tools["supervised_ceiling"]
        bank = load_digit_bank("auto", (28, 28))[0].cuda()
        with ceiling.f32_exact():
            run("CountCNN graphs against eager", ceiling_graph_check,
                ceiling, air, bank)
        out = run(f"supervised ceiling ({CEILING_STEPS} steps)", ceiling.main,
                  ["--steps", str(CEILING_STEPS), "--out",
                   os.path.join(tmp, "ceiling.json")])
        if out["n_scenes"] != 16 * 1024 or \
                not 0.0 <= out["supervised_accuracy"] <= 1.0:
            raise AssertionError(f"supervised ceiling: {out}")

        sweep = tools["iwae_ksweep"]
        for extra in (["--ks", "1", "5", "25"], ["--ks", "64", "--batches",
                                                 "1"]):
            out = run(f"IWAE k-sweep {' '.join(extra)}", sweep.main,
                      ["--workdir", workdirs["iwae"], *extra])
            if not all(math.isfinite(r["iwae_bound"]) for r in out["rows"]):
                raise AssertionError(f"IWAE k-sweep: {out}")

        # the CPU against the card: canonical (f32) through the tool's
        # command line, held to the kernel path's limits
        parity = tools["parity_check"]
        res = run("parity check canonical batch 16", parity.main,
                  ["--config", "canonical", "--batch", "16"])
        canvas, elbo = parity_gap(res["outputs"])
        print(f"  CPU against the card, canonical batch 16: presence "
              f"agreement {res['pres_agreement']:.4f}, canvas max abs err "
              f"{canvas:.3g}, elbo max rel err {elbo:.3g} (limits "
              f"{PARITY_LIMITS[0]}, {PARITY_LIMITS[1]}) on {smi}", flush=True)
        if not (canvas <= PARITY_LIMITS[0] and elbo <= PARITY_LIMITS[1]):
            raise AssertionError(f"parity canonical: canvas {canvas}, elbo "
                                 f"{elbo} outside {PARITY_LIMITS}")
        # canonical_fast at its batch: its bf16 matmuls round where the
        # two devices' f32 accumulators differ; the gap is reported beside
        # each device's distance from the f32 forward (PERF.md), not held
        fast = air.get_config("canonical_fast")
        outs = run("parity canonical_fast batch 1024", parity.parity, fast,
                   1024)
        res = parity.compare(outs["cpu"], outs["device"], 2e-2, 2e-2)
        gap = parity_gap(outs)
        cpu_f32, card_f32 = f32_gaps(parity, air, fast, outs, 1024)
        within = gap[0] <= PARITY_LIMITS[0] and gap[1] <= PARITY_LIMITS[1]
        print(f"  CPU against the card, canonical_fast batch 1024: presence "
              f"agreement {res['pres_agreement']:.4f}, canvas max abs err "
              f"{gap[0]:.3g}, elbo max rel err {gap[1]:.3g} "
              f"({'within' if within else 'outside'} the kernel path's "
              f"limits); the f32 forward against the CPU's bf16 one: "
              f"{cpu_f32[0]:.3g}, {cpu_f32[1]:.3g}, against the card's: "
              f"{card_f32[0]:.3g}, {card_f32[1]:.3g}; on {smi}", flush=True)

        for tool, argv in (("ablate_canonical", ["--variant", "ref"]),
                           ("probe_u28", ["--variant", "cap70"])):
            state = run(f"{tool} {argv[1]} ({VARIANT_STEPS} steps)",
                        tools[tool].main,
                        [*argv, "--iters", str(VARIANT_STEPS), "--workdir",
                         os.path.join(tmp, tool)])
            if state.step != VARIANT_STEPS:
                raise AssertionError(f"{tool}: step {state.step}")
        shapes = +st_kernel.shape_launches
        print(f"  phase 7e: {time.perf_counter() - t_phase:.1f} s wall; "
              f"{total[0]} forward and {total[1]} backward launches",
              flush=True)

        # both kernels on the IWAE forward's own inputs at k = 25 and 64,
        # and on the uniform presets' synthesis pastes (not counted)
        timed_rows = []
        cfg = air.get_config("iwae")
        state = tools["iwae_ksweep"].restore_state(cfg, workdirs["iwae"])
        imgs = air.make_synth_fn(cfg.data, load_digit_bank(
            "auto", cfg.data.digit_size, split="eval")[0])(
                1024, seeded_generator("cuda", 4321, 1000))[0]
        model = state.model.with_config(dataclasses.replace(
            cfg.model, explore_eps=None))
        for k in (25, 64):
            step = air.make_iwae_eval_step(cfg, model, n_particles=k)
            calls = record_kernel_calls(st_kernel, lambda: step(
                state, imgs, seeded_generator("cuda", 4321, 131 * k)))
            timed_rows += kernel_call_rows(st_kernel, calls,
                                           f"IWAE k={k}", bw, f32_peak)[0]
            del step, calls
        for name, digit in SYNTH_ROWS.items():
            data = air.get_config(name).data
            bank = load_digit_bank(data.source, data.digit_size)[0].cuda()
            calls = record_kernel_calls(
                st_kernel, lambda: air.synthesize_batch(
                    bank, data, 8192, seeded_generator("cuda", 0, 0)))
            timed_rows += kernel_call_rows(
                st_kernel, calls, f"{name} synthesis", bw, f32_peak,
                {digit: "paste"})[0]
        missing = [r["case"] for r in timed_rows if not shapes[r["key"]]]
        if missing:
            raise AssertionError(f"phase 7e launched no kernel at {missing}")
        st_kernel.launches = st_kernel.bwd_launches = 0
    return shapes, timed_rows


# Phase 8: every training preset but canonical_fast (phases 5-7), each at
# its own batch, widths, canvas and dtype mix, K steps a chunk.
PRESET_K = 4
# Launches per train step (forward, backward), as the code gives them: one
# synthesis paste, then a gather and a paste per cell step (the VIMCO
# objective's particles ride the batch of one forward); remat save_st
# recomputes no kernel (no preset uses remat "full", which would run each
# gather and paste again).  tests/test_torch_train.py holds the CPU step's
# kernel calls to the same.
PRESET_LAUNCHES = {"crowded": (11, 10), "iwae_trained": (7, 6),
                   "iwae": (7, 6), "canonical_uniform": (7, 6),
                   "canonical_uniform28": (7, 6), "single_digit": (3, 2),
                   "canonical": (7, 6), "no_nvil": (7, 6)}


def preset_chunk(air, cfg, model, bank, k):
    """``chunk(state) -> (state, rows)``: K steps as the preset trains
    them, its captured chunk, or K single steps of the single-step graph
    where the preset has no ``scan_steps`` (``no_nvil``); ``chunk.graphs``
    holds its graphs once captured."""
    if cfg.train.scan_steps > 1:
        return air.make_scan_train_step(cfg, model, bank, k)
    step = air.make_train_step(cfg, model, digit_bank=bank)

    def chunk(state):
        rows = []
        for _ in range(k):
            state, m = step(state)
            rows.append(m)
        return state, rows_of(rows)
    chunk.graphs = step.graphs
    return chunk


def bit_equal(what, a, b, got, want):
    """Two ``TrainState``s and their metric rows equal bit for bit, with
    the same step and update counts (the step's generators are seeded
    from those); raises with the largest gap otherwise."""
    n_differ, worst, err = state_gap(a, b)
    rows = rows_gap(got, want)
    counts = [(s.step, [s.opt_state[g].count for g in s.opt_state])
              for s in (a, b)]
    if n_differ or any(rows.values()) or counts[0] != counts[1]:
        raise AssertionError(
            f"{what}: {n_differ} tensors differ (worst {worst}: rel L2 "
            f"{err:.3g}), metric rows up to {max(rows.values()):.3g} rel, "
            f"step and counts {counts}")


def preset_phase(air, st_kernel, smi):
    """Each preset of ``PRESET_LAUNCHES`` at full width: K graphed steps
    (its chunk, or its single step) against the same K steps eager from
    one state, twice, bit-equal in state and metric rows; its launches per
    step; the log point's graphs (synthesis, eval, and IWAE where the
    preset logs it) against eager; walls, peak memory and graph pools.
    Then ``crowded``'s cap switch inside a chunk pair of ``train()``,
    graphed against eager.  Returns its launches by shape
    (``st_kernel.shape_launches``), and a ``crowded`` state and its
    single step for phase 8b."""
    from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
    from attend_infer_repeat_torch.eval import make_iwae_eval_step
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    k = PRESET_K
    st_kernel.launches = st_kernel.bwd_launches = 0
    st_kernel.shape_launches.clear()
    kept = None
    for i, name in enumerate(PRESET_LAUNCHES):
        cfg = air.get_config(name)
        per_step = PRESET_LAUNCHES[name]
        bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
        batch = cfg.train.batch_size
        graphed = air.create_train_state(cfg, seed=40 + i)
        eager = air.create_train_state(cfg, seed=40 + i)
        chunk = preset_chunk(air, cfg, graphed.model, bank, k)
        eager_chunk = preset_chunk(air, cfg, eager.model, bank, k)
        start = (st_kernel.launches, st_kernel.bwd_launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = {"graphed": [], "eager": []}
        for c in range(2):
            (graphed, got), dt = timed(chunk, graphed)
            walls["graphed"].append(dt / k)
            if c == 0:
                peak = torch.cuda.max_memory_allocated()
            with debug_mode(nans=False):
                (eager, want), dt = timed(eager_chunk, eager)
            walls["eager"].append(dt / k)
            bit_equal(f"{name} chunk {c}", graphed, eager, got, want)
            check_metrics(got, f"{name} chunk {c}")
        counts = (st_kernel.launches - start[0],
                  st_kernel.bwd_launches - start[1])
        steps = WARMUP + 4 * k          # warm-ups, 2K replays, 2K eager
        if counts != (steps * per_step[0], steps * per_step[1]):
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{per_step} a step over {steps} steps")
        pool = sum(e.graph.pool_bytes for e in chunk.graphs.values())
        what = ("its single step" if cfg.train.scan_steps <= 1
                else f"its chunk of {k}")
        print(f"  {name} (batch {batch}, {cfg.model.img_size[0]}x"
              f"{cfg.model.img_size[1]}, {cfg.model.max_steps} steps, "
              f"{cfg.model.dtype}, remat "
              f"{cfg.model.remat_policy if cfg.model.remat else 'off'}, "
              f"objective {cfg.train.objective}): {2 * k} steps through "
              f"{what} graphed and eager bit-equal (parameters, optimizer "
              f"state, {k} rows of {len(got)} metrics, step and counts); "
              f"{per_step[0]} forward and {per_step[1]} backward launches "
              f"a step; step wall graphed {walls['graphed'][1] * 1e3:.3f} ms"
              f" ({batch / walls['graphed'][1]:.1f} train img/s; the first "
              f"call, capture included, {walls['graphed'][0] * 1e3:.3f} ms a"
              f" step), eager {walls['eager'][1] * 1e3:.3f} ms "
              f"({walls['eager'][1] / walls['graphed'][1]:.2f}x); peak "
              f"memory {peak / 2**30:.2f} GiB; graph pool "
              f"{pool / 2**20:.1f} MiB; {smi}", flush=True)

        synth = make_synth_fn(cfg.data, bank)
        imgs, nums = versus(f"{name}: synthesis, batch {batch}", synth,
                            (batch,), 60 + i, batch, smi, reps=1)
        eval_step = air.make_eval_step(cfg, graphed.model)
        versus(f"{name}: eval step, batch {batch}",
               lambda g: eval_step(graphed, imgs, nums, g), (), 70 + i,
               batch, smi, eval_step.graphs, reps=1)
        if cfg.train.iwae_eval_particles:
            n = cfg.train.iwae_eval_particles
            iwae = make_iwae_eval_step(cfg, graphed.model.with_config(
                dataclasses.replace(cfg.model, explore_eps=None)), n)
            versus(f"{name}: IWAE step, {n} particles, batch {batch}",
                   lambda g: iwae(graphed, imgs, g), (), 80 + i, batch, smi,
                   iwae.graphs, reps=1)
            del iwae
        if name == "crowded":
            kept = (eager, air.make_train_step(cfg, eager.model,
                                               digit_bank=bank))
        del graphed, eager, chunk, eager_chunk, eval_step, synth
        torch.cuda.empty_cache()

    cap_switch_phase(air, st_kernel)
    shapes = +st_kernel.shape_launches
    for key, n in sorted(shapes.items()):
        kernel, n_ex, in_h, in_w, out_h, out_w = key
        print(f"  {kernel} {in_h}x{in_w}->{out_h}x{out_w}, N={n_ex}: {n} "
              f"launches in this phase", flush=True)
    return shapes, kept


def cap_switch_phase(air, st_kernel):
    """``train()`` on ``crowded`` with its window cap switching on at step
    K (``max_scale_from_step``; the preset's is 30,000): a chunk of the
    capless twin, then one of the capped model over the same parameters,
    each its own graph, against the same run eager."""
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    k = PRESET_K
    crowded = air.get_config("crowded")
    cfg = dataclasses.replace(
        crowded,
        model=dataclasses.replace(crowded.model, max_scale_from_step=k),
        train=dataclasses.replace(
            crowded.train, n_iters=2 * k, scan_steps=k, log_every=k,
            save_every=k, fig_every=2 * k, eval_batches=1))
    kw = dict(use_tensorboard=False, save_checkpoints=False)
    before = st_kernel.bwd_launches
    with tempfile.TemporaryDirectory(prefix="air_cap_") as tmp:
        graphed, dt = timed(air.train, cfg, workdir=os.path.join(tmp, "g"),
                            **kw)
        with debug_mode(nans=False):
            eager, dt_eager = timed(air.train, cfg,
                                    workdir=os.path.join(tmp, "e"), **kw)
        rows = [[{k_: v for k_, v in r.items() if k_ != "wall_s"}
                 for r in loop_rows(os.path.join(tmp, d))] for d in "ge"]
    a, b = state_arrays(graphed), state_arrays(eager)
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    if differ or {graphed.step, eager.step} != {2 * k} or rows[0] != rows[1]:
        raise AssertionError(f"crowded across the cap switch: graphed and "
                             f"eager differ in {differ[:5]} or the JSONL "
                             f"rows")
    steps = 2 * (WARMUP + k) + 2 * k      # a graph per phase, then eager
    bwd = st_kernel.bwd_launches - before
    if bwd != PRESET_LAUNCHES["crowded"][1] * steps:
        raise AssertionError(f"crowded across the cap switch: {bwd} "
                             f"backward launches over {steps} steps")
    print(f"  crowded across its cap switch (train() to step {2 * k}, the "
          f"cap {cfg.model.max_scale} from step {k}): a chunk of the capless "
          f"twin and one of "
          f"the capped model, each its own graph, bit-equal to the eager "
          f"run (parameters, optimizer state, {len(rows[0])} JSONL rows); "
          f"{bwd} backward launches; wall {dt:.2f} s graphed, "
          f"{dt_eager:.2f} s eager", flush=True)


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

    print("[3c] the fused paste against the unfused ops, bit for bit",
          flush=True)
    acc_rows = accumulate_phase(st_kernel, invert_where, bw, f32_peak)

    print(f"[3e] the indexed gather against plain (limits f32 {F32_TOL}, "
          f"g_zw {BWD_TOL[1]} of max(1, max|plain|)) and against the kernels "
          f"on copies, bit for bit", flush=True)
    indexed_rows, indexed_bwd_rows = indexed_phase(st_kernel, bw)

    print("[3d] the LSTM kernels against their plain twins, bit for bit",
          flush=True)
    lstm_rows, lstm_bwd_rows = lstm_phase(bw, f32_peak)

    # each kernel's launches in the phases that run the program (4, 5, 5c,
    # 5d, 5e, 7, 7b, 7d, 7e and 8; not the checks and timings of 3-3e, 5b, 6,
    # 7c and 8b), from the ST kernels' launches by shape and the LSTM
    # kernels' counts
    from attend_infer_repeat_torch.models import modules
    phase_launches = collections.Counter()
    lstm_names = {"fused": "lstm_cell", "fused_bwd": "lstm_cell_bwd"}

    def add_launches(shapes, lstm=None):
        for (kernel, *_), c in shapes.items():
            phase_launches[kernel] += c
        for key, c in (lstm or {}).items():
            phase_launches[lstm_names[key]] += c

    def counted(phase, *args):
        before = collections.Counter(st_kernel.shape_launches)
        lstm = collections.Counter(modules.lstm_counts)
        out = phase(*args)
        add_launches(st_kernel.shape_launches - before,
                     modules.lstm_counts - lstm)
        return out

    modules.lstm_counts.clear()

    print("[4] the serving slice", flush=True)
    counted(slice_phase, air, st_kernel, smi)

    print("[5] the train step", flush=True)
    from attend_infer_repeat_torch.data import load_digit_bank
    fast = air.get_config("canonical_fast")
    bank, _ = load_digit_bank(fast.data.source, fast.data.digit_size)
    state, step = counted(train_phase, air, st_kernel, smi, bank)

    print("[5b] both kernels on one train step's own inputs", flush=True)
    step_rows, step_bwd_rows = step_kernel_phase(st_kernel, state, step, bw,
                                                 f32_peak)
    del state, step

    print("[5c] the K-step chunk as a replayed CUDA graph", flush=True)
    counted(graph_phase, air, st_kernel, smi, bank)

    print("[5d] the other entry points as CUDA graphs against eager",
          flush=True)
    counted(entry_points_phase, air, st_kernel, smi, bank)

    print("[5e] SPACE's train step, graphed against eager", flush=True)
    from attend_infer_repeat_torch.models import space
    st_kernel.launches = st_kernel.bwd_launches = 0
    st_kernel.shape_launches.clear()
    space.space_counts.clear()
    counted(space_phase, air, st_kernel, smi)

    print("[6] one step through the plain ST on the card", flush=True)
    plain_step_phase(air, st_kernel, STEP_LIMITS)

    print("[7] the training loop", flush=True)
    counted(loop_phase, air, st_kernel, smi)

    print("[7b] data parallelism on a one-rank NCCL mesh", flush=True)
    counted(mesh_phase, air, st_kernel, bank, smi)

    print("[7c] utils: a trace of a graphed chunk, the NaN trap", flush=True)
    utils_phase(air, bank)

    print("[7d] the reference workflow: dataset pickles, train() from them "
          "(resident, streamed), the CLI, the evaluator, the override "
          "runner, the explain-away selection", flush=True)
    counted(workflow_phase, air, st_kernel, smi, bank)

    print("[7e] the analysis tools: overlap characterization, overlap "
          "errors, supervised ceiling, IWAE k-sweep, CPU-card parity, "
          "ablation and probe runners", flush=True)
    lstm = collections.Counter(modules.lstm_counts)
    analysis_shapes, analysis_rows = analysis_phase(air, st_kernel, smi, bw,
                                                    f32_peak)
    add_launches(analysis_shapes, modules.lstm_counts - lstm)

    print(f"[8] every other training preset at full width: K = {PRESET_K} "
          f"steps graphed against eager", flush=True)
    lstm = collections.Counter(modules.lstm_counts)
    preset_shapes, (crowded, crowded_step) = preset_phase(air, st_kernel,
                                                           smi)
    add_launches(preset_shapes, modules.lstm_counts - lstm)

    print("[8b] both kernels on one crowded train step's own inputs",
          flush=True)
    crowded_rows, crowded_bwd_rows = step_kernel_phase(
        st_kernel, crowded, crowded_step, bw, f32_peak, label="crowded step")
    del crowded, crowded_step
    missing = {r["key"] for r in crowded_rows + crowded_bwd_rows
               if not preset_shapes[r["key"]]}
    if missing:
        raise AssertionError(f"phase 8 launched no kernel at crowded's step "
                             f"shapes {sorted(missing)}")

    def kernel_line(name, source, replaces, rows, head_case):
        # the launches of phase 8 by shape: every preset's, crowded's too
        by_shape = [{"shape": f"{h}x{w}->{oh}x{ow}", "n": n, "launches": c}
                    for (k, n, h, w, oh, ow), c in sorted(
                        preset_shapes.items()) if k == name]
        timed = [r for r in rows if "ms" in r]
        head = next(r for r in timed if head_case(r["case"], r["n"]))
        keys = ("case", "n", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")
        return {
            "name": name, "route": "cuda",
            "source": f"attend_infer_repeat_torch/csrc/{source}",
            "replaces": f"attend_infer_repeat_tpu/ops/pallas_st.py:{replaces}",
            "launches": phase_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_abs_err_bf16": max(r["max_abs_err_bf16"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": f"{head['case']} N={head['n']}",
            "shapes": [{k: r[k] for k in keys} for r in timed],
            "preset_launches_by_shape": by_shape,
            "analysis_launches_by_shape": [
                {"shape": f"{h}x{w}->{oh}x{ow}", "n": n, "launches": c}
                for (k, n, h, w, oh, ow), c in sorted(
                    analysis_shapes.items()) if k == name],
        }

    fwd_rows = rows + step_rows + crowded_rows + analysis_rows
    fused = [r.get("key", ("",))[0] == ACC_KEY for r in fwd_rows]
    def lstm_line(name, rows):
        head = next(r for r in rows if r["n"] == 5 * N_TRAIN)
        keys = ("case", "n", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bits_differ", "library_bits_differ")
        if not phase_launches[name]:
            raise AssertionError(f"the main paths launched no {name}")
        return {
            "name": name, "route": "cuda",
            "source": "attend_infer_repeat_torch/csrc/lstm_cell.cu",
            "replaces": "none: XLA fuses models/modules.py LSTMCell's "
                        "elementwise ops",
            "launches": phase_launches[name],
            "bits_differ": max(r["bits_differ"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "shapes": [{k: r[k] for k in keys} for r in rows],
        }

    def indexed_line(name, source, replaces, rows):
        head = next(r for r in rows if "ms" in r)
        keys = ("case", "n", "ms", "copies_ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err")
        if not phase_launches[name]:
            raise AssertionError(f"the main paths launched no {name}")
        return {
            "name": name, "route": "cuda",
            "source": f"attend_infer_repeat_torch/csrc/{source}",
            "replaces": f"attend_infer_repeat_tpu/ops/pallas_st.py:{replaces}"
                        f" (one image a window there)",
            "launches": phase_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "copies_ms": head["copies_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "shape": f"{head['case']} N={head['n']}",
            "shapes": [{k: r[k] for k in keys} for r in rows if "ms" in r],
        }

    kernels = [
        kernel_line("st_gather", "st_gather.cu", 54,
                    [r for r, f in zip(fwd_rows, fused) if not f],
                    lambda c, n: (c, n) == ("gather 50x50->20x20", N_SERVE)),
        kernel_line(ACC_KEY, "st_gather.cu", 54,
                    acc_rows + [r for r, f in zip(fwd_rows, fused) if f],
                    lambda c, n: c.startswith("fused paste 20x20->50x50 "
                                              "(serve)")),
        kernel_line("st_gather_bwd", "st_gather_bwd.cu", 155,
                    bwd_rows + step_bwd_rows + crowded_bwd_rows,
                    lambda c, n: c.startswith("step paste bwd")),
        indexed_line("st_gather_indexed", "st_gather.cu", 54, indexed_rows),
        indexed_line("st_gather_bwd_indexed", "st_gather_bwd.cu", 155,
                     indexed_bwd_rows),
        lstm_line("lstm_cell", lstm_rows),
        lstm_line("lstm_cell_bwd", lstm_bwd_rows),
    ]
    print("[9] kernels", flush=True)
    print(f"  total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
