"""PyTorch port: ``models.modules._ParticleDense``, the bf16 layer of a
forward at k·B rows that gives each of the k particles' row blocks the
bits of a forward and backward of that block alone.

Its block GEMMs write into one buffer, side by side on the card (one
side stream a block) and in turn elsewhere.  Here, on the CPU, it is held
bit for bit against the formulation that joins the blocks' results
(``helpers/torch_joined_blocks.py``), and its GEMM groups are counted
(``particle_counts``).  ``tests/test_torch_particles_cuda.py`` holds the
side-by-side blocks on the card.
"""

import collections
import dataclasses

import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.data import load_digit_bank
from attend_infer_repeat_torch.models import modules
from attend_infer_repeat_torch.train import (
    create_train_state,
    make_train_step,
)
from attend_infer_repeat_torch.train.step import objective_counts
from helpers.torch_joined_blocks import JoinedBlocks, output_and_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("width_in, width_out", [(7, 3), (16, 12), (40, 50)])
@pytest.mark.parametrize("k", [2, 5])
def test_particle_dense_equals_the_joined_blocks(k, width_in, width_out):
    """bf16, with a bias: the output and the gradients of the input, the
    weight and the bias equal the joined blocks' bit for bit, and each
    call counts a forward group and a weight-gradient group, none forked
    on the CPU."""
    gen = torch.Generator().manual_seed(1000 * k + width_in)
    layer = torch.nn.Linear(width_in, width_out)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen))
        layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen))
    x = torch.randn(k * 6, width_in, generator=gen).to(torch.bfloat16)
    grad = torch.randn(k * 6, width_out, generator=gen).to(torch.bfloat16)
    inputs = (x.requires_grad_(), layer.weight, layer.bias, grad, k)
    want = output_and_grads(JoinedBlocks, *inputs)
    before = collections.Counter(modules.particle_counts)
    got = output_and_grads(modules._ParticleDense, *inputs)
    counts = modules.particle_counts - before
    assert got[0].dtype == torch.bfloat16
    for name, a, b in zip(("out", "x", "weight", "bias"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert counts["groups"] == 2 and counts["forked"] == 0


def test_a_wide_iwae_step_counts_its_groups():
    """One ``iwae_trained`` step at its full widths (batch cut to 2) runs
    72 groups of block GEMMs: 8 bf16 layer uses a cell step (encoder, the
    where MLP and its two heads, the what MLP and its two heads, the steps
    MLP) over 3 cell steps, in the forward, remat's recompute and the
    weight gradient; none is forked on the CPU."""
    cfg = tcfg.get_config("iwae_trained")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2))
    assert cfg.model.remat and cfg.model.max_steps == 3
    bank, _ = load_digit_bank("auto", digit_size=cfg.data.digit_size)
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, state.model, digit_bank=bank)
    counters = (objective_counts, modules.particle_counts)
    before = [collections.Counter(c) for c in counters]
    step(state)
    steps, counts = (c - b for c, b in zip(counters, before))
    assert steps["steps"] == 1
    assert counts["groups"] == 72 and counts["forked"] == 0
