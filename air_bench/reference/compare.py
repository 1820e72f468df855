"""The numbers that decide ``correct``, each compared with its limit.

Training: the reference follows the first three steps of the program's
first call from the same weights, data and noise.  ``<reading>_gap.<s>``
is the relative gap of what step s reports (``reference.train.READINGS``):
the surrogate loss, the ELBO and its three KL terms (batch means: the
model group's forward, and from step 2 its update), the baseline's
regression (the baseline group's) and the whole gradient's norm before
clipping.  The loss and the gradient are almost all the baseline's
regression at these weights, so the ELBO's terms carry the model group.
Each step is its own number: from step 2 on the gaps grow, since
RMSProp's first update moves every weight by about the learning rate
whatever its gradient's size, so a rounding that turns the sign of a
near-zero gradient moves that weight the other way.

Serving: the reference runs the forward of sampled requests on their
canvases and noise.  A window is comparable while both presence chains
agree on every earlier step (the canvas it sees depends on them):
``where_gap`` is the largest difference of a comparable window,
``presence_mismatch`` the share of comparable presence samples that
differ, ``count_mismatch`` the share of images whose most probable count
differs.
"""

from __future__ import annotations

import torch


def train_numbers(program: dict, reference: dict) -> dict:
    """``program``, ``reference``: ``{reading: [...]}`` of the same steps,
    for the readings both report."""
    return {f"{key}_gap.{s + 1}": abs(p - r) / abs(r)
            for key in reference if key in program
            for s, (p, r) in enumerate(zip(program[key], reference[key]))}


def serve_numbers(program: dict, reference: dict) -> dict:
    """Both: ``z_where (B, T, 4)``, ``presence (B, T)``, ``mode_steps (B,)``
    on the CPU."""
    pp, pr = program["presence"], reference["presence"]
    same = (pp == pr)
    agree = torch.cat([torch.ones_like(same[:, :1], dtype=torch.int32),
                       torch.cumprod(same.int(), dim=1)[:, :-1]], dim=1).bool()
    gap = (program["z_where"] - reference["z_where"]).abs().amax(-1)
    gap = torch.where(agree, gap, torch.zeros_like(gap))
    gap = torch.nan_to_num(gap, nan=float("inf"))
    return {
        "where_gap": float(gap.max()),
        "presence_mismatch": float((~same & agree).sum() / agree.sum()),
        "count_mismatch": float((program["mode_steps"]
                                 != reference["mode_steps"]).float().mean()),
    }


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for each number ``limits``
    names; raises on a limit with no number."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
