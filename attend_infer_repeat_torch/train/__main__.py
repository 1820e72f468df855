"""CLI entry point: ``python -m attend_infer_repeat_torch.train``.

The JAX package's argparse surface over the named presets, plus
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses

from attend_infer_repeat_torch.configs import PRESETS, get_config
from attend_infer_repeat_torch.train.loop import train


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m attend_infer_repeat_torch.train",
        description="Train Attend-Infer-Repeat (PyTorch, CUDA).")
    p.add_argument("--config", default="canonical", choices=sorted(PRESETS),
                   help="preset name")
    p.add_argument("--workdir", default=None,
                   help="checkpoint/log dir (default runs/<config>)")
    p.add_argument("--iters", type=int, default=None,
                   help="override number of training iterations")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="computation dtype override (params stay f32)")
    p.add_argument("--scan-steps", type=int, default=None,
                   help="train steps per host dispatch override "
                        "(numerics-neutral; log/fig/save intervals must "
                        "be multiples)")
    p.add_argument("--remat", dest="remat", action="store_true",
                   default=None,
                   help="force backward-pass rematerialization on")
    p.add_argument("--no-remat", dest="remat", action="store_false",
                   help="force rematerialization off")
    p.add_argument("--st-method", default=None, choices=["xla", "pallas"],
                   help="accepted for the JAX package's command lines; no "
                        "effect here (the spatial transformer is the CUDA "
                        "kernel on the card, plain PyTorch on the CPU)")
    p.add_argument("--data", default=None, metavar="PATH",
                   help="train from a reference-format pickle instead of "
                        "on-device synthesis")
    p.add_argument("--eval-data", default=None, metavar="PATH",
                   help="validation pickle (with --data; default: a 90/10 "
                        "split of the training pickle)")
    p.add_argument("--stream-data", action="store_true",
                   help="with --data: stream batches from the host per "
                        "step instead of keeping the dataset on the device")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument("--no-checkpoints", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default cuda; never falls back)")
    args = p.parse_args(argv)

    config = get_config(args.config)
    overrides = {}
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.scan_steps is not None:
        overrides["scan_steps"] = args.scan_steps
    if overrides:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, **overrides))
    model_overrides = {}
    if args.dtype is not None:
        model_overrides["dtype"] = args.dtype
    if args.remat is not None:
        model_overrides["remat"] = args.remat
    if args.st_method is not None:
        model_overrides["st_method"] = args.st_method
    if model_overrides:
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model,
                                              **model_overrides))

    workdir = args.workdir or f"runs/{args.config}"
    train(config, workdir=workdir, n_iters=args.iters,
          resume=not args.no_resume,
          use_tensorboard=not args.no_tensorboard,
          save_checkpoints=not args.no_checkpoints,
          data_path=args.data, eval_data_path=args.eval_data,
          resident_data=not args.stream_data, device=args.device)


if __name__ == "__main__":
    main()
