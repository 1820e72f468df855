"""The PyTorch port's forward on the CPU against the same forward on the
card: the north star's numerical parity check.

The port's counterpart of ``scripts/parity_check.py``.  It runs one
forward pass with the same weights, images and noise on the CPU (the
plain spatial transformer) and on CUDA (the hand-written kernels), and
compares ``elbo``, ``canvas``, ``kl_what``, ``kl_where``, ``kl_steps``,
``pres``, ``pres_prob`` and the count pmf.  The noise is drawn once on the
CPU and copied to the card, since the two devices' generators give
different streams.  Presence samples are compared for agreement; the
other outputs only on the examples whose presence agrees (a uniform draw
that falls between the two devices' probabilities flips a sample).

    python3 scripts/torch_parity_check.py [--batch 16] [--config canonical]

``--precision`` sets ``torch.set_float32_matmul_precision``: ``highest``
(the default: f32 matmuls, TF32 off), ``high`` (TF32) or ``default``
("medium").  Exits nonzero on a mismatch beyond ``--rtol``/``--atol``,
and when there is no card: a parity check that passes without the device
would hide the device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    make_synth_fn,
)
from attend_infer_repeat_torch.models import AIRModel  # noqa: E402

PRECISION = {"highest": "highest", "high": "high", "default": "medium"}
PRIOR_SUCCESS = 0.5


@torch.no_grad()
def forward_outputs(model, imgs, noise) -> dict:
    """The compared outputs of one forward, as numpy arrays."""
    out = model(imgs, PRIOR_SUCCESS, noise=noise)
    got = {"elbo": out.elbo, "canvas": out.canvas, "kl_what": out.kl_what,
           "kl_where": out.kl_where, "kl_steps": out.kl_steps,
           "pres": out.steps.pres, "pres_prob": out.steps.pres_prob,
           "pmf": out.num_steps_pmf}
    return {k: v.float().cpu().numpy() for k, v in got.items()}


def compare(out_cpu: dict, out_dev: dict, rtol: float, atol: float) -> dict:
    """The JAX script's comparison: presence agreement, then every other
    output on the examples whose presence agrees, its largest error
    relative to ``|cpu| + 1`` and whether it is ``allclose``.  Also each
    output's largest absolute error there (``abs_err``).  Prints a line
    per output; returns ``ok``, ``pres_agreement``, ``n_compared`` and the
    per-output ``rel_err``, ``abs_err`` and ``good``."""
    pres_cpu, pres_dev = out_cpu["pres"], out_dev["pres"]
    agree = float((pres_cpu == pres_dev).mean())
    print(f"pres sample agreement: {agree:.4f}")
    if agree < 1.0:
        print("  (boundary draws differ; downstream tolerances apply only "
              "where samples agree)")
    match = (pres_cpu == pres_dev).all(axis=-1)
    res = {"pres_agreement": agree, "n_compared": int(match.sum()),
           "rel_err": {}, "abs_err": {}, "good": {}}
    for name in out_cpu:
        if name == "pres":
            continue
        a, b = out_cpu[name][match], out_dev[name][match]
        diff = np.abs(a - b)
        res["rel_err"][name] = float(np.max(diff / (np.abs(a) + 1.0),
                                            initial=0.0))
        res["abs_err"][name] = float(np.max(diff, initial=0.0))
        res["good"][name] = bool(np.allclose(a, b, rtol=rtol, atol=atol))
        print(f"{name:10s} max rel err {res['rel_err'][name]:.3e}  "
              f"{'OK' if res['good'][name] else 'FAIL'}")
    res["ok"] = all(res["good"].values())
    return res


def parity_inputs(cfg, batch: int):
    """``cfg``'s model on the CPU (seed 0), ``batch`` canvases (generator
    seed 1) and one draw of the forward's noise (seed 0)."""
    bank, _ = load_digit_bank(cfg.data.source, cfg.data.digit_size)
    imgs, _ = make_synth_fn(cfg.data, bank, device="cpu")(
        batch, torch.Generator().manual_seed(1))
    model = AIRModel(cfg.model, device="cpu", seed=0)
    return model, imgs, model.sample_noise(batch,
                                           torch.Generator().manual_seed(0))


def parity(cfg, batch: int, device="cuda") -> dict:
    """``compare``'s inputs: the outputs of one forward on
    ``parity_inputs`` on the CPU and on ``device``."""
    model, imgs, noise = parity_inputs(cfg, batch)
    on_dev = AIRModel(cfg.model, device=device, seed=0)
    on_dev.load_state_dict(model.state_dict())
    return {"cpu": forward_outputs(model, imgs, noise),
            "device": forward_outputs(on_dev, imgs.to(device),
                                      tuple(t.to(device) for t in noise))}


def main(argv=None) -> dict:
    """Run the check; returns ``compare``'s dict with both devices'
    ``outputs``.  Exits nonzero on a mismatch or with no card."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rtol", type=float, default=2e-2)
    p.add_argument("--atol", type=float, default=2e-2)
    p.add_argument("--precision", default="highest", choices=list(PRECISION),
                   help="f32 matmul precision on the card; 'highest' keeps "
                        "TF32 off so the residual error is roundoff")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_parity_check: no CUDA card; a parity check "
                         "without the device would hide the device")

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(PRECISION[args.precision])
    try:
        outs = parity(get_config(args.config), args.batch)
    finally:
        torch.set_float32_matmul_precision(prev)
    res = compare(outs["cpu"], outs["device"], args.rtol, args.atol)
    if not res["ok"]:
        raise SystemExit(1)
    print("parity OK on", torch.cuda.get_device_name(0), flush=True)
    return dict(res, outputs=outs)


if __name__ == "__main__":
    main()
