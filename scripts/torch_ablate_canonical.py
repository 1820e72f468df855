"""Controlled ablation of the reference training regime, with the PyTorch
port.

The port's counterpart of ``scripts/ablate_canonical.py``, with the same
variants and flags plus ``--device`` (default ``cuda``; with no card it
raises unless given ``--device cpu``).  Each variant starts from the
literal reconstruction of the reference regime (batch 64, RMSProp lr
1e-5, 4-dim ``z_where``, no explore floor, output std 0.3, scale prior
0.05) and adds one group of fixes, at the reference's operating point:

  ref         the literal reconstruction
  ref+prior   + the generative-prior fixes (output std 0.15, isotropic
                scale prior 0.03)
  ref+expl    + explore_eps 0.05
  ref+cap     + the window-scale cap 0.45
  ref+anneal  the literal model with a slower, gentler count-prior anneal
  ref+both    + prior and explore fixes
  ref+fast    + both, grad clip 100 and a 50,000-step KL warmup
  ref+all     + both, the cap, grad clip 100 and the KL warmup

    python3 scripts/torch_ablate_canonical.py --variant ref+prior \\
        --iters 150000
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.train.loop import train  # noqa: E402

VARIANTS = ("ref", "ref+prior", "ref+expl", "ref+cap", "ref+anneal",
            "ref+both", "ref+fast", "ref+all")


def make_variant(name: str):
    """The ``canonical``-based config of variant ``name``."""
    cfg = get_config("canonical")
    # The shipped `canonical` preset carries one documented flip
    # (explore_eps=0.05); the literal baseline must not inherit it, so
    # every literal reconstruction value is pinned here, and later preset
    # edits cannot confound the ablation.
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, explore_eps=None, output_std=0.3,
            where_prior_scale=(0.05, 0.05, 1.0, 1.0),
            isotropic_scale=False, max_scale=None))

    prior_fix = dict(output_std=0.15,
                     where_prior_scale=(0.03, 0.03, 1.0, 1.0),
                     isotropic_scale=True)
    explore_fix = dict(explore_eps=0.05)
    # the hard cap on the attention-window scale (configs.py,
    # canonical_fast)
    cap_fix = dict(max_scale=0.45)

    model_kw = {}
    train_kw = {}
    if name == "ref":
        pass
    elif name == "ref+prior":
        model_kw.update(prior_fix)
    elif name == "ref+expl":
        model_kw.update(explore_fix)
    elif name == "ref+cap":
        model_kw.update(cap_fix)
    elif name == "ref+anneal":
        # everything literal except a slower, gentler count-prior anneal
        return dataclasses.replace(
            cfg, name="canonical_ablate_ref_anneal",
            prior=dataclasses.replace(
                cfg.prior, final_success_prob=1e-2,
                anneal_start=20_000, anneal_steps=400_000))
    elif name == "ref+both":
        model_kw.update(prior_fix)
        model_kw.update(explore_fix)
    elif name == "ref+fast":
        model_kw.update(prior_fix)
        model_kw.update(explore_fix)
        train_kw.update(grad_clip_norm=100.0, kl_warmup_steps=50_000)
    elif name == "ref+all":
        model_kw.update(prior_fix)
        model_kw.update(explore_fix)
        model_kw.update(cap_fix)
        train_kw.update(grad_clip_norm=100.0, kl_warmup_steps=50_000)
    else:
        raise SystemExit(f"unknown variant {name!r}")

    return dataclasses.replace(
        cfg,
        name=f"canonical_ablate_{name}",
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, **train_kw))


def main(argv=None):
    """Train the variant; returns ``train()``'s final ``TrainState``."""
    p = argparse.ArgumentParser()
    p.add_argument("--variant", required=True)
    p.add_argument("--iters", type=int, default=150_000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default cuda; never falls back)")
    args = p.parse_args(argv)

    cfg = make_variant(args.variant)
    workdir = args.workdir or f"runs/ablate_{args.variant.replace('+', '_')}"
    return train(cfg, workdir=workdir, n_iters=args.iters,
                 use_tensorboard=False, device=args.device)


if __name__ == "__main__":
    main()
