"""Train a preset with ad-hoc config overrides, with the PyTorch port.

The port's counterpart of ``scripts/run_variant.py`` (experiment
campaigns), with the same flags plus ``--device`` (default ``cuda``; with
no card it raises unless given ``--device cpu``):

    python3 scripts/torch_run_variant.py --config crowded \\
        --workdir runs/crowded_v2 --data-set "digit_size=(20,20)" \\
        --data-set "cell_margin=0.08" --model-set "encoder_conv=(16,32)" \\
        --iters 150000

Override values are parsed with ``ast.literal_eval`` and must name
existing fields of ModelConfig / TrainConfig / DataConfig /
PriorAnnealConfig (``configs.apply_overrides``: typos raise at once).
Evaluate the run with ``scripts/torch_eval_checkpoint.py`` and the same
``--model-set``/``--data-set``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch.configs import (  # noqa: E402
    apply_overrides,
    get_config,
)
from attend_infer_repeat_torch.train.loop import train  # noqa: E402


def main(argv=None):
    """Train the variant; returns ``train()``'s final ``TrainState``."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical_fast")
    p.add_argument("--workdir", required=True)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--model-set", action="append", metavar="KEY=VALUE")
    p.add_argument("--train-set", action="append", metavar="KEY=VALUE")
    p.add_argument("--data-set", action="append", metavar="KEY=VALUE")
    p.add_argument("--prior-set", action="append", metavar="KEY=VALUE")
    p.add_argument("--no-checkpoints", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default cuda; never falls back)")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    cfg = dataclasses.replace(
        cfg,
        model=apply_overrides(cfg.model, args.model_set),
        train=apply_overrides(cfg.train, args.train_set),
        data=apply_overrides(cfg.data, args.data_set),
        prior=apply_overrides(cfg.prior, args.prior_set))
    return train(cfg, workdir=args.workdir, n_iters=args.iters,
                 use_tensorboard=False,
                 save_checkpoints=not args.no_checkpoints,
                 device=args.device)


if __name__ == "__main__":
    main()
