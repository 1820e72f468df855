"""PyTorch port: VIMCO's k particles along the batch, on the card.

The ``iwae`` step runs its k particles as one forward at batch k·B, and
each particle's bf16 weight gradients are rounded on their own
(``models.modules.dense``), as k forwards at batch B round them.  At the
``iwae_trained`` preset's full widths and batch:

- the graphed chunk replays bit for bit what the eager steps give;
- step 1's readings (the VIMCO loss, the bound, the ELBO and its KL
  terms, the gradient's norm) are held against the particle loop
  (``tests/helpers/torch_particle_loop.py``) on the same weights,
  canvases and draws, at half the benchmark's step-1 limits
  (``air_bench/workloads/train.iwae_trained.json``);
- whether each layer's GEMMs over all the rows (or batched over the
  blocks) give each particle's rows what a GEMM on those rows alone gives
  is printed (``-s``) and not held: cuBLAS may pick another kernel for
  another row count, which is why the forward and the weight's gradient
  run one GEMM a particle.

Needs a CUDA card and ``nvcc``; every test skips without a card.  Run on
the card without the JAX package's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \
        tests/test_torch_particles_cuda.py
"""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from attend_infer_repeat_torch import configs as tcfg
from helpers.torch_particle_loop import looped_iwae_loss

pytestmark = pytest.mark.cuda

LIMITS = Path(__file__).resolve().parents[1] / "air_bench" / "workloads" \
    / "train.iwae_trained.json"
READINGS = ("loss", "iwae_bound", "elbo", "kl_what", "kl_where",
            "kl_steps", "grad_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bank():
    from attend_infer_repeat_torch.data import load_digit_bank

    return load_digit_bank("auto", digit_size=(16, 16))[0]


def test_wide_iwae_chunk_graph_equals_eager(cuda, bank):
    """Two graphed 2-step chunks of ``iwae_trained`` equal four eager steps
    from the same state, bit for bit: parameters, optimizer state and
    every metric row."""
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step)
    from attend_infer_repeat_torch.utils import debug_mode

    cfg = tcfg.get_config("iwae_trained")
    graphed = create_train_state(cfg, seed=11)
    eager = create_train_state(cfg, seed=11)
    scan = make_scan_train_step(cfg, graphed.model, bank, 2)
    eager_scan = make_scan_train_step(cfg, eager.model, bank, 2)
    for _ in range(2):
        graphed, got = scan(graphed)
        with debug_mode(nans=False):
            eager, want = eager_scan(eager)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert graphed.step == eager.step == 4
    a, b = graphed.model.state_dict(), eager.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for g, st in graphed.opt_state.items():
        other = eager.opt_state[g]
        assert st.count == other.count
        assert all(torch.equal(x, y) for x, y in zip(st.nu, other.nu))
        assert all(torch.equal(x, y) for x, y in zip(st.trace, other.trace))


def step_one(cfg, state, bank, wide: bool) -> tuple:
    """Step 1's readings, the forward's outputs and the gradients of the
    wide ``iwae`` loss or of the particle loop, on the step's canvases and
    draws (``train.step.step_generators``)."""
    from attend_infer_repeat_torch.data.synth import synthesize_batch
    from attend_infer_repeat_torch.train import prior_success_prob
    from attend_infer_repeat_torch.train.state import global_norm
    from attend_infer_repeat_torch.train.step import (
        kl_warmup, make_objective_loss_fn, step_generators)

    model = state.model
    dev = model.device
    g_data, g_model = step_generators(state.base_seed, 0, dev)
    with torch.no_grad():
        imgs, _ = synthesize_batch(torch.as_tensor(bank).to(dev), cfg.data,
                                   cfg.train.batch_size, g_data)
    p_success = prior_success_prob(cfg.prior, 0).to(dev)
    kl_beta = torch.as_tensor(kl_warmup(cfg, 0)).to(dev)
    if wide:
        loss, (metrics, out) = make_objective_loss_fn(
            cfg, model, imgs, g_model, p_success, kl_beta)()
    else:
        loss, metrics, out = looped_iwae_loss(cfg, model, imgs, g_model,
                                              p_success, kl_beta)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    got = dict(metrics, loss=loss, grad_norm=global_norm(grads))
    return {k: got[k].item() for k in READINGS}, out, grads


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 4_000_000_017])
def test_wide_step_one_matches_the_particle_loop(cuda, bank, seed):
    """At full width, step 1's readings of the wide step lie within half
    the benchmark's step-1 limits of the particle loop's; the gaps, and
    whether the forward's readings were bit-equal, are printed."""
    from attend_infer_repeat_torch.train import create_train_state

    cfg = tcfg.get_config("iwae_trained")
    limits = json.loads(LIMITS.read_text())["limits"]
    state = create_train_state(cfg, seed=seed)
    wide, _, _ = step_one(cfg, state, bank, wide=True)
    loop, _, _ = step_one(cfg, state, bank, wide=False)
    gaps = {k: abs(wide[k] - loop[k]) / abs(loop[k]) for k in READINGS}
    print(json.dumps({"seed": seed, "step_one_gaps": gaps,
                      "forward_bit_equal": {k: wide[k] == loop[k]
                                            for k in READINGS}}))
    for k, gap in gaps.items():
        assert gap <= limits[f"{k}_gap.1"] / 2, (k, gap)


def test_record_wide_gemms_against_row_slices(cuda):
    """For each layer of the cell at ``iwae_trained``'s widths and batch
    (k = 5, B = 1024), on random inputs: is one forward GEMM over all the
    rows each particle's row-slice GEMM, bit for bit, and are the input
    gradient's one GEMM, a weight GEMM batched over the blocks and the
    blocks' bias sums each block's own?  Printed; nothing is held but
    that the answers exist."""
    from attend_infer_repeat_torch.models.air import AIRModel
    from attend_infer_repeat_torch.models.modules import (
        compute_dtype, decoder_dtype)

    cfg = tcfg.get_config("iwae_trained")
    k, batch = cfg.train.iwae_particles, cfg.train.batch_size
    model = AIRModel(cfg.model, use_baseline=False, device=cuda)
    cell, d, dd = model.cell, compute_dtype(cfg.model), \
        decoder_dtype(cfg.model)
    layers = {
        "encoder": (cell.encoder.mlp.dense[0], d),
        "where.mlp": (cell.where.mlp.dense[0], d),
        "where.loc": (cell.where.head.loc, d),
        "what.mlp": (cell.what.mlp.dense[0], d),
        "what.loc": (cell.what.head.loc, d),
        "steps.mlp": (cell.steps.mlp.dense[0], d),
        "steps.logit": (cell.steps.logit, torch.float32),
        "lstm.ih": (cell.lstm.ih, torch.float32),
        "lstm.hh": (cell.lstm.hh, torch.float32),
        "decoder.0": (model.decoder.mlp.dense[0], dd),
        "decoder.1": (model.decoder.mlp.dense[1], dd),
    }
    gen = torch.Generator(cuda).manual_seed(0)
    found = {}
    with torch.no_grad():
        for name, (layer, dtype) in layers.items():
            w = layer.weight.to(dtype)
            b = None if layer.bias is None else layer.bias.to(dtype)
            x = torch.randn((k * batch, w.shape[1]), generator=gen,
                            device=cuda).to(dtype)
            g = torch.randn((k * batch, w.shape[0]), generator=gen,
                            device=cuda).to(dtype)
            xs, gs = x.chunk(k), g.chunk(k)
            blocks = g.reshape(k, batch, -1)
            per_block = torch.bmm(blocks.transpose(1, 2),
                                  x.reshape(k, batch, -1))
            found[name] = {
                "dtype": str(dtype),
                "forward": torch.equal(F.linear(x, w, b), torch.cat(
                    [F.linear(r, w, b) for r in xs])),
                "input_grad": torch.equal(g.mm(w), torch.cat(
                    [r.mm(w) for r in gs])),
                "weight_grad_batched": all(
                    torch.equal(per_block[j], gs[j].t().mm(xs[j]))
                    for j in range(k)),
                "bias_grad_blocks": all(
                    torch.equal(s, r.sum(0))
                    for s, r in zip(blocks.sum(1), gs)),
            }
    print(json.dumps({"wide_gemms_bit_equal_to_row_slices": found,
                      "device": torch.cuda.get_device_name(0)}))
    assert set(found) == set(layers)
