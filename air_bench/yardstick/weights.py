"""The model's weights, made by the benchmark on the device from the seed.

Every matrix is drawn in one call, a normal truncated at two standard
deviations with variance 1/fan_in (as flax's ``lecun_normal``); biases
are zero but the presence logit's, which starts at ``steps_bias``.  The
same weights go into the program's model and into the reference.
"""

from __future__ import annotations

import math

import torch

from air_bench.reference.air import param_shapes
from air_bench.yardstick import derived_seed

_TRUNC_STD = 0.87962566103423978     # std of a unit normal cut at +-2


def make(cfg: dict, use_baseline: bool, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for the configuration's model."""
    shapes = param_shapes(cfg["model"], use_baseline)
    gen = torch.Generator(device).manual_seed(derived_seed(seed, "weights"))
    mats = [(n, s) for n, s in shapes.items() if len(s) == 2]
    flat = torch.empty(sum(math.prod(s) for _, s in mats), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            n = math.prod(shape)
            std = math.sqrt(1.0 / shape[1]) / _TRUNC_STD
            params[name] = (flat[at:at + n] * std).reshape(shape)
            at += n
        else:
            params[name] = torch.zeros(shape, device=device)
    params["cell.steps.logit.bias"].fill_(cfg["model"]["steps_bias"])
    return params
