"""CPU pre-screen of the 28 px preset's probe variants, with the PyTorch
port.

The port's counterpart of ``scripts/cpu_prescreen_u28.py``: it trains a
variant of ``scripts/torch_probe_u28.py`` on the CPU (by design, as its
name says) for ``--iters`` steps, logging every 1,000, saving every 2,000
and drawing no figures, into ``runs/u28_cpu_<variant>`` (or
``--workdir``), apart from the probes' workdirs so that a card run never
resumes from a CPU pre-screen's checkpoint.  The early steps show whether
a variant keeps the count accuracy that the KL warmup erodes.

    python3 scripts/torch_cpu_prescreen_u28.py --variant slimdec \\
        [--iters 8000]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))
sys.path.insert(0, _SCRIPTS)

from attend_infer_repeat_torch.train.loop import train  # noqa: E402
from torch_probe_u28 import make_variant  # noqa: E402


def prescreen_config(variant: str, iters: int, seed: int = 0):
    """The probe variant with the pre-screen's name, seed and cadence."""
    cfg = make_variant(variant)
    return dataclasses.replace(
        cfg,
        name=f"u28_cpu_{variant}",
        train=dataclasses.replace(
            cfg.train, seed=seed,
            # CPU cadence: half the eval overhead, no figures
            log_every=1_000, fig_every=iters + 1, save_every=2_000))


def main(argv=None):
    """Train the variant on the CPU; returns ``train()``'s final
    ``TrainState``."""
    p = argparse.ArgumentParser()
    p.add_argument("--variant", required=True)
    p.add_argument("--iters", type=int, default=8_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=None,
                   help="default runs/u28_cpu_<variant>")
    args = p.parse_args(argv)

    cfg = prescreen_config(args.variant, args.iters, args.seed)
    return train(cfg, workdir=args.workdir or f"runs/u28_cpu_{args.variant}",
                 n_iters=args.iters, use_tensorboard=False, device="cpu")


if __name__ == "__main__":
    main()
