"""Short probe runs of the 28 px forced-overlap preset's variants, with the
PyTorch port.

The port's counterpart of ``scripts/probe_u28.py``, with the same variants,
flags and workdir rule plus ``--device`` (default ``cuda``; with no card
it raises unless given ``--device cpu``) and ``--workdir`` (default the
JAX script's ``runs/u28_probe_<variant>``, ``_s<seed>`` appended for a
seed other than 0).  Every variant is defined against the frozen baseline
of ``canonical_uniform28`` with ``n_what`` 50 (``base``), and changes one
group of settings:

  geometry     cap62, cap70, tight, glim28
  stability    advnorm, clip10, softlik
  count prior  prior3, prior2, priormild, prior3_glim28, sharplik,
               prior3_sharplik, what20prior5
  capacity     slimdec, dec128, what20, what32

    python3 scripts/torch_probe_u28.py --variant cap62 [--iters 25000]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.train.loop import train  # noqa: E402

VARIANTS = ("base", "cap62", "cap70", "tight", "glim28", "dec128", "what32",
            "what20prior5", "advnorm", "clip10", "softlik", "prior3",
            "sharplik", "prior3_sharplik", "prior3_glim28", "prior2",
            "priormild", "slimdec", "what20")


def make_variant(name: str):
    """The ``canonical_uniform28``-based config of variant ``name``."""
    cfg = get_config("canonical_uniform28")
    if name not in VARIANTS:
        raise SystemExit(f"unknown variant {name!r}; have {sorted(VARIANTS)}")
    # Every probe is defined against the frozen baseline with n_what=50:
    # the preset later shipped n_what=20, and inheriting that would
    # confound every variant that does not set n_what itself.
    m = dict(n_what=50)
    d = dict()
    t = dict()
    pr = dict()
    # geometry
    if name == "cap62":
        d.update(scale_range=(0.7, 1.0))
        m.update(max_scale=0.62,
                 where_prior_loc=(0.48, 0.48, 0.0, 0.0),
                 where_prior_scale=(0.03, 0.03, 1.0, 1.0))
    elif name == "cap70":
        m.update(max_scale=0.70,
                 where_prior_scale=(0.03, 0.03, 1.0, 1.0))
    elif name == "tight":
        m.update(where_prior_scale=(0.03, 0.03, 1.0, 1.0))
    elif name == "glim28":
        m.update(max_scale=0.70,
                 where_prior_scale=(0.03, 0.03, 1.0, 1.0),
                 glimpse_size=(28, 28))
    # stability after the anneal
    if name == "advnorm":
        t.update(advantage_norm=True)         # NVIL variance normalization
    elif name == "clip10":
        t.update(grad_clip_norm=10.0)
    elif name == "softlik":
        m.update(output_std=0.3)              # the reference's own output std
    # the count prior and the likelihood's stake (merge economics)
    if name == "prior3":
        pr.update(final_success_prob=1e-3)
    elif name == "prior2":
        pr.update(final_success_prob=1e-2)
    elif name == "priormild":
        pr.update(final_success_prob=0.3)
    elif name == "prior3_glim28":
        pr.update(final_success_prob=1e-3)
        m.update(glimpse_size=(28, 28))
    elif name == "sharplik":
        m.update(output_std=0.10)
    elif name == "prior3_sharplik":
        pr.update(final_success_prob=1e-3)
        m.update(output_std=0.10)
    # capacity: limit what one window can represent
    elif name == "slimdec":
        m.update(decoder_hidden=(64,))
    elif name == "dec128":
        m.update(decoder_hidden=(128,))
    elif name == "what20":
        m.update(n_what=20)
    elif name == "what32":
        m.update(n_what=32)
    elif name == "what20prior5":
        m.update(n_what=20)
        pr.update(final_success_prob=1e-5)
    return dataclasses.replace(
        cfg, name=f"u28_probe_{name}",
        model=dataclasses.replace(cfg.model, **m),
        data=dataclasses.replace(cfg.data, **d),
        train=dataclasses.replace(cfg.train, **t),
        prior=dataclasses.replace(cfg.prior, **pr))


def main(argv=None):
    """Train the variant; returns ``train()``'s final ``TrainState``."""
    p = argparse.ArgumentParser()
    p.add_argument("--variant", required=True)
    p.add_argument("--iters", type=int, default=25_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=None,
                   help="default runs/u28_probe_<variant>[_s<seed>]")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default cuda; never falls back)")
    args = p.parse_args(argv)

    cfg = make_variant(args.variant)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, seed=args.seed))
    # seed 0 keeps the historical workdir; other seeds get their own, so
    # restore-or-init never resumes across seeds
    suffix = "" if args.seed == 0 else f"_s{args.seed}"
    workdir = args.workdir or f"runs/u28_probe_{args.variant}{suffix}"
    return train(cfg, workdir=workdir, n_iters=args.iters,
                 use_tensorboard=False, device=args.device)


if __name__ == "__main__":
    main()
