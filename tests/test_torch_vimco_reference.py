"""PyTorch port: the VIMCO-trained configuration (``iwae_trained``, the
k = 5 importance-weighted bound) against the benchmark's plain reference.

``air_bench/configs/iwae_trained_k5.json`` is cut to tiny widths here; the
port's K-step entry (``make_scan_train_step``) and the plain PyTorch
reference (``air_bench.reference``, no JAX, no kernels) start from the
same seeded random weights (``air_bench.yardstick.weights``) and take the
same 3 steps on the same canvases and particle draws, paired as
``air_bench/traffic/chunks.py`` pairs them: the reference regenerates the
program's step seeds, its synthesis and each particle's noise in turn.
On the CPU both run the plain spatial transformer and the same matmul
mix, so they differ only by the order of f32 sums.
"""

import copy
import dataclasses

import pytest
import torch

from air_bench import layout, program
from air_bench.reference import synth
from air_bench.reference.train import Trainer, readings
from air_bench.yardstick import weights
from attend_infer_repeat_torch.configs import get_config

torch.set_num_threads(1)

STEPS = 3
EPS = torch.finfo(torch.float32).eps
#: The ELBO and its KL terms, the same ops on the same draws on both
#: sides, and the gradient's norm, a sum of squares over every parameter
#: that the two sides take in another order: a few f32 roundings of the
#: value (measured ≤ 1.1e-7 relative over 20 seeds).
RTOL = 1e-6
#: The loss and the bound are logsumexps of the particles' log weights,
#: which are of the ELBO's size, less log k: their rounding is relative
#: to the log weights and not to the result, which can lie near 0 (a
#: bound of 0.35 from log weights near -100 differed by 5.7e-6, 1.6e-5
#: relative).  So they are held to 16 f32 roundings of the ELBO's size.
LOGW_ULPS = 16


def tiny_iwae_config() -> dict:
    """The committed configuration at tiny widths and batch, its
    objective, switches and dtypes kept."""
    cfg = copy.deepcopy(layout.load("configs", "iwae_trained_k5")["config"])
    cfg["model"].update(
        img_size=[12, 12], glimpse_size=[4, 4], n_what=3, rnn_hidden=8,
        encoder_hidden=[8], glimpse_encoder_hidden=[8], decoder_hidden=[8],
        transform_hidden=[8], steps_hidden=[4])
    cfg["data"].update(canvas_size=[12, 12], digit_size=[4, 4])
    cfg["train"].update(batch_size=8, scan_steps=STEPS)
    return cfg


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 4_000_000_017])
def test_iwae_steps_match_the_plain_reference(seed):
    cfg, cpu = tiny_iwae_config(), torch.device("cpu")
    bank = synth.digit_bank(cfg["data"]["digit_size"], cpu)
    state = program.train_state(cfg, weights.make(cfg, False, seed, cpu),
                                seed, cpu)
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, STEPS)
    state, rows = scan(state)
    ref = Trainer(cfg, weights.make(cfg, False, seed, cpu), bank,
                  seed).follow(STEPS)
    assert state.step == STEPS
    assert set(readings(cfg)) == {"loss", "iwae_bound", "elbo", "kl_what",
                                  "kl_where", "kl_steps", "grad_norm"}
    for key in readings(cfg):
        for s in range(STEPS):
            got, want = rows[key][s].item(), ref[key][s]
            if key in ("loss", "iwae_bound"):
                tol = LOGW_ULPS * EPS * abs(ref["elbo"][s])
            else:
                tol = RTOL * abs(want)
            assert abs(got - want) <= tol, (key, s + 1, got, want)


def test_the_benchmark_configuration_is_the_preset():
    """``iwae_trained_k5.json`` builds the port's ``iwae_trained`` preset,
    field for field."""
    doc = layout.load("configs", "iwae_trained_k5")
    assert doc["preset"] == "iwae_trained" and doc["reduced"] == []
    got, want = program.config(doc["config"]), get_config("iwae_trained")
    assert got.name == want.name == "iwae_trained"
    for section in ("model", "prior", "train", "data"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section)), section
    assert got == want
