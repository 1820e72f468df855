"""Profile serving requests of the PyTorch port on the card.

    python3 scripts/torch_profile_serving.py [--preset serving] [--batch 8192]

Builds the preset's model (random weights from a seed, no NVIL baseline),
synthesizes one batch of canvases, then:

- times 10 requests with the host clock around ``torch.cuda.synchronize``;
- traces 3 requests with ``torch.profiler`` and prints the device time by
  kernel, the kernel launches per request and the device's busy share,
  both of the traced wall time and of the unprofiled median wall.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="serving")
    ap.add_argument("--batch", type=int, default=8192)
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
    cfg = air.get_config(args.preset)
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
    gen = torch.Generator("cuda").manual_seed(0)
    imgs, _ = make_synth_fn(cfg.data, bank)(args.batch, gen)
    model = air.AIRModel(cfg.model, use_baseline=False, seed=0)
    infer = air.make_infer_fn(cfg, model)
    for _ in range(3):
        infer(imgs, gen)
    torch.cuda.synchronize()

    walls = []
    for _ in range(10):
        t = time.perf_counter()
        infer(imgs, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    walls.sort()
    print(f"{args.preset} batch {args.batch}: request wall ms min "
          f"{walls[0] * 1e3:.3f} median {walls[5] * 1e3:.3f}; img/s at the "
          f"median {args.batch / walls[5]:.1f}")

    n_req = 3
    st_kernel.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n_req):
            infer(imgs, gen)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    print(f"traced {n_req} requests: wall {traced * 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, {len(kernels) / n_req:.0f} device ops per "
          f"request, {st_kernel.launches // n_req} of them st_gather")
    print(f"device busy share: {100 * busy / (traced * 1e6):.1f}% of the "
          f"traced wall; {100 * busy / n_req / (walls[5] * 1e6):.1f}% of the "
          f"unprofiled median wall (profiled busy per request over it)")
    print("device us per request, by kernel (top 15):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / n_req:10.1f} us  {n // n_req:4d}x  "
              f"{100 * us / busy:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
