"""PyTorch port: SPACE (``models/space.py``) against the benchmark's plain
reference (``air_bench/reference/space.py``), at tiny widths on the CPU.

``air_bench/configs/space_g16.json`` is cut to tiny widths (the traffic
kind's ``tiny_config``: 32 × 32 scenes, a 4 × 4 grid, 8 × 8 glimpses,
widths of 8, K = 2); the port and the plain PyTorch reference (no JAX, no
kernels) start from the same seeded random weights
(``reference.space.make_weights``) and see the same scenes and noise: the
reference regenerates the program's step seeds, its scene synthesis and
its draws in order.  On the CPU both run the plain spatial transformer,
so they differ only by the order of f32 sums.
"""

import collections

import pytest
import torch

from air_bench import layout, program
from air_bench.reference import space as rspace
from air_bench.reference import synth
from air_bench.reference.precision import Precision
from attend_infer_repeat_torch.data.synth import synthesize_scenes
from attend_infer_repeat_torch.models import space
from attend_infer_repeat_torch.ops import distributions, st_kernel
from attend_infer_repeat_torch.train.step import SCHEDULE
from attend_infer_repeat_torch.utils import graphs

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEPS = 3
#: Every reading and the forward's terms: the same ops on the same draws,
#: summed in another order (the plain spatial transformer's products, the
#: gradient's sum of squares).
RTOL = 1e-5

SCENES = layout.kind("scenes")


def tiny_config(batch: int = 4) -> dict:
    cfg = SCENES.tiny_config(layout.load("configs", "space_g16")["config"])
    cfg["train"].update(batch_size=batch, scan_steps=STEPS)
    return cfg


def model_of(cfg: dict, seed: int):
    state = SCENES.train_state(cfg, rspace.make_weights(cfg, seed, CPU),
                               seed, CPU)
    return state


def test_names_and_shapes_are_the_references():
    cfg = tiny_config()
    model = model_of(cfg, 1).model
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(s) for n, s in rspace.param_shapes(cfg).items()}
    full = layout.load("configs", "space_g16")["config"]
    model = space.SpaceModel(program.config(full).model,
                             SCENES.space_config(full), device=CPU)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(s) for n, s in rspace.param_shapes(full).items()}


def test_scenes_are_the_references():
    cfg = tiny_config(batch=6)
    bank = synth.digit_bank(cfg["data"]["digit_size"], CPU)
    got, nums = synthesize_scenes(
        bank, program.config(cfg).data, SCENES.space_config(cfg), 6,
        torch.Generator().manual_seed(9))
    want, want_nums = rspace.synthesize(bank, cfg["data"], cfg["space"], 6,
                                        torch.Generator().manual_seed(9))
    assert got.shape == (6, 3, 32, 32)
    assert torch.equal(nums, want_nums)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    lo, hi = cfg["data"]["min_digits"], cfg["data"]["max_digits"]
    assert bool(((nums >= lo) & (nums <= hi)).all())


def _forward_both(cfg, seed):
    """The port's and the reference's forward of one batch, from the
    same weights, scenes and noise; ``(port outputs, reference dict,
    port model, reference params)``."""
    state = model_of(cfg, seed)
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in rspace.make_weights(cfg, seed, CPU).items()}
    bank = synth.digit_bank(cfg["data"]["digit_size"], CPU)
    x, _ = rspace.synthesize(bank, cfg["data"], cfg["space"],
                             cfg["train"]["batch_size"],
                             torch.Generator().manual_seed(seed))
    noise = rspace.sample_noise(cfg, x.shape[0],
                                torch.Generator().manual_seed(seed + 1), CPU)
    rho, mu_s = torch.tensor(0.1), torch.tensor(-1.0)
    out = state.model(x, rho, mu_s.reshape(1), noise=tuple(noise))
    ref = rspace.Space(cfg, params).forward(x, rho, mu_s, noise)
    return out, ref, state.model, params


def test_forward_terms_and_gradients_are_the_references():
    cfg = tiny_config()
    out, ref, model, params = _forward_both(cfg, 21)
    for key in ("elbo", "log_likelihood", "kl_pres", "kl_where", "kl_depth",
                "kl_what", "kl_bg"):
        torch.testing.assert_close(getattr(out, key), ref[key], rtol=RTOL,
                                   atol=0), key
    (-out.elbo.mean()).backward()
    grads = torch.autograd.grad(rspace.elbo_loss(ref["elbo"]),
                                list(params.values()))
    for (name, p), g in zip(params.items(), grads):
        got = dict(model.named_parameters())[name].grad
        scale = max(1.0, float(g.abs().max()))
        assert float((got - g).abs().max()) <= 1e-4 * scale, name


def test_three_steps_follow_the_reference():
    """``make_scan_train_step`` on the CPU (the card's Python, eagerly)
    against ``reference.space.Trainer``: every reading of steps 1..3."""
    cfg = tiny_config()
    seed = 2 ** 31 + 5
    state = model_of(cfg, seed)
    bank = synth.digit_bank(cfg["data"]["digit_size"], CPU)
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, STEPS)
    assert (space.__name__, "space_counts") in graphs.CARRIED
    counts = space.space_counts.copy()
    state, rows = scan(state)
    assert space.space_counts - counts == {
        "cells": STEPS * 4 * 16, "glimpses": STEPS * 4 * 16 * 3,
        "components": STEPS * 4 * 2}
    want = rspace.Trainer(cfg, rspace.make_weights(cfg, seed, CPU), bank,
                          seed).follow(STEPS)
    for key in rspace.READINGS:
        torch.testing.assert_close(rows[key], torch.tensor(want[key]),
                                   rtol=RTOL, atol=0), key
    assert state.step == STEPS


def test_the_schedule_row_carries_the_scale_prior():
    """SPACE's step reads ``z_scale``'s annealed prior mean after the
    ``SCHEDULE`` values; AIR's row is as long as ``SCHEDULE``."""
    from attend_infer_repeat_torch.train.step import _TrainStep

    cfg = tiny_config()
    state = model_of(cfg, 3)
    ts = _TrainStep(program.config(cfg), state.model,
                    digit_bank=torch.zeros(2, 4, 4))
    state.step = 15_000
    row = ts.schedule(state)
    assert row.shape == (len(SCHEDULE) + 1,)
    assert float(row[-1]) == pytest.approx(-1.5)
    assert float(row[0]) == pytest.approx(0.01)
    air_cfg = layout.load("configs", "canonical_fast")["config"]
    air = program.air().create_train_state(program.config(air_cfg), seed=0,
                                           device=CPU)
    assert _TrainStep(program.config(air_cfg), air.model).schedule(
        air).shape == (len(SCHEDULE),)


@pytest.mark.parametrize("logit", [-3.0, 0.0, 2.2])
def test_relaxed_bernoulli_is_torchs(logit):
    tau = 2.5
    logits = torch.full((1000,), logit)
    u = torch.rand(1000, generator=torch.Generator().manual_seed(4))
    y = distributions.logit_relaxed_bernoulli_sample(logits, u, tau)
    want = torch.distributions.relaxed_bernoulli.LogitRelaxedBernoulli(
        torch.tensor(tau), logits=logits).log_prob(y)
    got = distributions.logit_relaxed_bernoulli_log_prob(y, logits, tau)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_stick_breaking_masks_sum_to_one():
    cfg = tiny_config()
    model = model_of(cfg, 8).model
    bank = synth.digit_bank(cfg["data"]["digit_size"], CPU)
    x, _ = rspace.synthesize(bank, cfg["data"], cfg["space"], 4,
                             torch.Generator().manual_seed(2))
    noise = model.sample_noise(4, torch.Generator().manual_seed(3))
    with torch.no_grad():
        log_pi, mu, _ = model._background(x, noise[5], noise[6])
    assert log_pi.shape == (4, 2, 32, 32) and mu.shape == (4, 2, 3, 32, 32)
    torch.testing.assert_close(torch.exp(log_pi).sum(1),
                               torch.ones(4, 32, 32), rtol=0, atol=1e-6)
    # the reference's ``stick`` fault drops π_K: the masks no longer sum to 1
    params = rspace.make_weights(cfg, 8, CPU)
    ref = rspace.Space(cfg, params)
    ref.stick = False
    log_pi, _, _ = ref.background(x, noise[5], noise[6])
    assert float(torch.exp(log_pi).sum(1).max()) < 1.0 - 1e-3


def test_indexed_plain_gather_is_the_gather_of_copies():
    g = torch.Generator().manual_seed(6)
    img = torch.rand((5, 12, 12), generator=g)
    zw = torch.cat([0.2 + torch.rand((9, 2), generator=g),
                    2 * torch.rand((9, 2), generator=g) - 1], 1)
    src = torch.tensor([0, 4, 4, 2, 1, 0, 3, 3, 3], dtype=torch.int32)
    copies = img[src.long()]
    assert torch.equal(st_kernel.st_gather_plain(img, zw, (4, 5), src=src),
                       st_kernel.st_gather_plain(copies, zw, (4, 5)))
    cot = torch.randn((9, 4, 5), generator=g)
    none, g_zw = st_kernel.st_gather_bwd_plain(img, zw, cot, (4, 5),
                                               need_img=False, src=src)
    assert none is None and torch.equal(
        g_zw, st_kernel.st_gather_bwd_plain(copies, zw, cot, (4, 5),
                                            need_img=False)[1])
    with pytest.raises(ValueError, match="no image gradient"):
        st_kernel.st_gather_bwd_plain(img, zw, cot, (4, 5), src=src)
    # through autograd: the window's gradient, and none for the images
    zw_ = zw.clone().requires_grad_(True)
    st_kernel.STGather.apply(img, zw_, (4, 5), src).mul(cot).sum().backward()
    assert torch.equal(zw_.grad, g_zw)


def test_the_reference_is_plain_and_its_control_differs():
    """The reference at one precision lower (TF32 operands) moves every
    reading at step 1: the control the limits are set against."""
    cfg = tiny_config()
    seed = 77
    bank = synth.digit_bank(cfg["data"]["digit_size"], CPU)
    w = rspace.make_weights(cfg, seed, CPU)
    ref = rspace.Trainer(cfg, w, bank, seed).follow(1)
    low = rspace.Trainer(cfg, w, bank, seed, Precision(lower=True)).follow(1)
    assert all(low[k] != ref[k] for k in ("loss", "log_likelihood",
                                          "grad_norm"))
    counts = collections.Counter(type(v).__name__ for v in w.values())
    assert counts == {"Tensor": len(w)}
