"""Profile serving requests, or train steps, of the PyTorch port on the card.

    python3 scripts/torch_profile_serving.py [--preset serving] [--batch 8192]
    python3 scripts/torch_profile_serving.py --train [--preset canonical_fast]
        [--batch 1024] [--k 20] [--eager] [--no-remat]

Serving builds the preset's model (random weights from a seed, no NVIL
baseline) and synthesizes one batch of canvases; ``--train`` builds the
preset's train state and its K-step chunk (``make_scan_train_step``: on
the card one captured step replayed K times; synthesis inside the step,
batch 1024 by default), or with ``--eager`` the eager one-step
``make_train_step``; ``--no-remat`` turns the preset's remat off.  Then,
for one unit of work (a request, or a train step; a chunk's numbers are
divided by its K steps):

- times 10 units with the host clock around ``torch.cuda.synchronize``;
- traces 3 units with ``torch.profiler`` and prints the device time by
  kernel, the device operations per unit (a replayed graph's kernels
  each count), the kernel wrappers' launch counts per unit and the
  device's busy share, both of the traced wall time and of the
  unprofiled median wall.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of serving requests")
    ap.add_argument("--preset", default=None,
                    help="serving (default) or, with --train, canonical_fast")
    ap.add_argument("--batch", type=int, default=None,
                    help="8192 (serving) or 1024 (--train) by default")
    ap.add_argument("--k", type=int, default=20,
                    help="--train: steps per graphed chunk")
    ap.add_argument("--eager", action="store_true",
                    help="--train: the eager one-step make_train_step")
    ap.add_argument("--no-remat", action="store_true",
                    help="--train: turn the preset's remat off")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    import attend_infer_repeat_torch as air
    from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
    from attend_infer_repeat_torch.ops import st_kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    preset = args.preset or ("canonical_fast" if args.train else "serving")
    batch = args.batch or (1024 if args.train else 8192)
    cfg = air.get_config(preset)
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
    gen = torch.Generator("cuda").manual_seed(0)
    per = 1                                   # units of work per call
    # bring the profiler (CUPTI) up before a graph is captured, so that
    # the trace sees the replayed kernels one by one
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
    if args.train:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=batch), model=dataclasses.replace(
            cfg.model, remat=cfg.model.remat and not args.no_remat))
        state = air.create_train_state(cfg, seed=0)
        unit = "train step"
        if args.eager:
            step = air.make_train_step(cfg, state.model, digit_bank=bank)
        else:
            step = air.make_scan_train_step(cfg, state.model, bank, args.k)
            per = args.k
        print(f"{'eager step' if args.eager else f'graphed chunk of {per}'}"
              f", remat {cfg.model.remat_policy if cfg.model.remat else 'off'}")

        def work():
            step(state)
    else:
        imgs, _ = make_synth_fn(cfg.data, bank)(batch, gen)
        model = air.AIRModel(cfg.model, use_baseline=False, seed=0)
        infer = air.make_infer_fn(cfg, model)
        unit = "request"

        def work():
            infer(imgs, gen)
    for _ in range(3):
        work()
    torch.cuda.synchronize()

    walls = []
    for _ in range(10):
        t = time.perf_counter()
        work()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) / per)
    walls.sort()
    print(f"{preset} batch {batch}: {unit} wall ms min "
          f"{walls[0] * 1e3:.3f} median {walls[5] * 1e3:.3f}; img/s at the "
          f"median {batch / walls[5]:.1f}")

    n_units = 3 * per
    st_kernel.launches = st_kernel.bwd_launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n_units // per):
            work()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    print(f"traced {n_units} {unit}s: wall {traced * 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, {len(kernels) / n_units:.0f} device ops "
          f"per {unit}, {st_kernel.launches // n_units} of them st_gather, "
          f"{st_kernel.bwd_launches // n_units} st_gather_bwd")
    print(f"device busy share: {100 * busy / (traced * 1e6):.1f}% of the "
          f"traced wall; {100 * busy / n_units / (walls[5] * 1e6):.1f}% of "
          f"the unprofiled median wall (profiled busy per {unit} over it)")
    print(f"device us per {unit}, by kernel (top 15):")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / n_units:10.1f} us  {n // n_units:4d}x  "
              f"{100 * us / busy:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
