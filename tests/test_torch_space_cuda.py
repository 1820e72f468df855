"""PyTorch port: SPACE's kernels and step on the card.

- The indexed gather (``st_gather_cuda(..., src=...)``) and its window
  gradient are bit-equal to the one-to-one kernels run on a materialised
  ``img[src]``, at SPACE's shapes (128 × 128 scenes, 32 × 32 glimpses) and
  at a ragged count; asking it for an image gradient raises.
- At the benchmark configuration's widths
  (``air_bench/configs/space_g16.json``) with the batch cut to 8 scenes,
  two graphed 2-step chunks of ``make_scan_train_step`` equal four eager
  steps from the same state, bit for bit: parameters, optimizer state and
  every metric row; and a step launches the ST kernels as counted, with
  ``space_counts`` counted through the replays.

Needs a CUDA card and ``nvcc``; every test skips without a card.  Run on
the card without the JAX package's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_space_cuda.py
"""

import copy

import pytest
import torch

from air_bench import layout, program

pytestmark = pytest.mark.cuda

BATCH = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def indexed_inputs(images, windows, side, seed, dev):
    g = torch.Generator(dev).manual_seed(seed)
    img = torch.rand((images, side, side), generator=g, device=dev)
    zw = torch.cat([0.05 + 0.9 * torch.rand((windows, 2), generator=g,
                                            device=dev),
                    2.5 * torch.rand((windows, 2), generator=g, device=dev)
                    - 1.25], 1)
    src = torch.randint(0, images, (windows,), generator=g, device=dev,
                        dtype=torch.int32)
    return img, zw, src


@pytest.mark.parametrize("images,windows", [(96, 24_576), (7, 1_023)])
def test_indexed_gather_is_the_kernel_on_copies(cuda, images, windows):
    from attend_infer_repeat_torch.ops import st_kernel

    img, zw, src = indexed_inputs(images, windows, 128, images, cuda)
    copies = img[src.long()].contiguous()
    before = st_kernel.shape_launches.copy()
    got = st_kernel.st_gather_cuda(img, zw, (32, 32), src=src)
    want = st_kernel.st_gather_cuda(copies, zw, (32, 32))
    assert torch.equal(got, want)
    g = torch.randn_like(got)
    none, g_zw = st_kernel.st_gather_bwd_cuda(img, zw, g, (32, 32),
                                              need_img=False, src=src)
    _, want_zw = st_kernel.st_gather_bwd_cuda(copies, zw, g, (32, 32),
                                              need_img=False)
    assert none is None and torch.equal(g_zw, want_zw)
    added = st_kernel.shape_launches - before
    assert added[("st_gather_indexed", windows, 128, 128, 32, 32)] == 1
    assert added[("st_gather_bwd_indexed", windows, 128, 128, 32, 32)] == 1


def test_indexed_gather_has_no_image_gradient(cuda):
    from attend_infer_repeat_torch.ops import st_kernel

    img, zw, src = indexed_inputs(4, 16, 32, 3, cuda)
    g = torch.ones((16, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="no image gradient"):
        st_kernel.st_gather_bwd_cuda(img, zw, g, (8, 8), src=src)
    x = img.clone().requires_grad_(True)
    out = st_kernel.STGather.apply(x, zw, (8, 8), src)
    with pytest.raises(ValueError, match="no image gradient"):
        out.sum().backward()


def setup(cuda, seed):
    from air_bench.reference import space as rspace
    from air_bench.reference import synth

    cfg = copy.deepcopy(layout.load("configs", "space_g16")["config"])
    cfg["train"]["batch_size"] = BATCH
    scenes = layout.kind("scenes")
    bank = synth.digit_bank(cfg["data"]["digit_size"], cuda)
    state = scenes.train_state(cfg, rspace.make_weights(cfg, seed, cuda),
                               seed, cuda)
    return cfg, bank, state


def test_space_chunk_graph_equals_eager(cuda):
    from attend_infer_repeat_torch.models import space
    from attend_infer_repeat_torch.utils import debug_mode
    from attend_infer_repeat_torch.utils.graphs import WARMUP

    cfg, bank, graphed = setup(cuda, 11)
    _, _, eager = setup(cuda, 11)
    c = program.config(cfg)
    scan = program.air().make_scan_train_step(c, graphed.model, bank, 2)
    eager_scan = program.air().make_scan_train_step(c, eager.model, bank, 2)
    cells = cfg["space"]["grid"] ** 2
    for forwards in (WARMUP + 2, 2):
        before = space.space_counts.copy()
        graphed, got = scan(graphed)
        # the first call's warm-ups count too, its capture does not
        assert (space.space_counts - before)["cells"] == \
            forwards * BATCH * cells
        with debug_mode(nans=False):
            eager, want = eager_scan(eager)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (k, got[k], want[k])
        assert torch.isfinite(got["loss"]).all()
    assert graphed.step == eager.step == 4
    a, b = graphed.model.state_dict(), eager.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for g, st in graphed.opt_state.items():
        other = eager.opt_state[g]
        assert st.count == other.count
        assert all(torch.equal(x, y) for x, y in zip(st.nu, other.nu))
        assert all(torch.equal(x, y) for x, y in zip(st.trace, other.trace))


def test_st_launches_a_step_are_as_counted(cuda):
    from attend_infer_repeat_torch.models import space
    from attend_infer_repeat_torch.ops import st_kernel

    cfg, bank, state = setup(cuda, 5)
    q = cfg["space"]
    cells, c = q["grid"] ** 2, q["channels"]
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, 2)
    state, _ = scan(state)                  # capture, then replay
    before = st_kernel.shape_launches.copy()
    counts = space.space_counts.copy()
    state, _ = scan(state)
    torch.cuda.synchronize()
    added = st_kernel.shape_launches - before
    side, (gh, gw) = cfg["model"]["img_size"][0], q["glimpse_size"]
    d = cfg["data"]
    assert added == {
        ("st_gather", BATCH * d["max_digits"], *d["digit_size"], side,
         side): 2,
        ("st_gather_indexed", BATCH * cells * c, side, side, gh, gw): 2,
        ("st_gather_bwd_indexed", BATCH * cells * c, side, side, gh, gw): 2,
        ("st_gather", BATCH * cells * (c + 1), gh, gw, side, side): 2,
        ("st_gather_bwd", BATCH * cells * (c + 1), gh, gw, side, side): 2,
    }, added
    assert space.space_counts - counts == {
        "cells": 2 * BATCH * cells, "glimpses": 2 * BATCH * cells * c,
        "components": 2 * BATCH * q["components"]}
