"""PyTorch port: Sequential AIR (``models/sqair.py``) on the card, at the
benchmark configuration's widths (``air_bench/configs/sqair_k5.json``,
10 frames, 3 slots, k = 5) with the batch cut to 128 sequences:

- two graphed 2-step chunks of ``make_scan_train_step`` equal four eager
  steps from the same state, bit for bit: parameters, optimizer state and
  every metric row;
- a step launches the spatial-transformer kernels as counted: one
  synthesis paste, then per frame and slot three gathers and two fused
  pastes forward; backward the same five but the first frame's proposal
  gathers, whose window and image need no gradient
  (``air_bench/yardstick/sqair_work.py`` counts the same).

Needs a CUDA card and ``nvcc``; every test skips without a card.  Run on
the card without the JAX package's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_sqair_cuda.py
"""

import copy

import pytest
import torch

from air_bench import layout, program

pytestmark = pytest.mark.cuda

BATCH = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def setup(cuda, seed):
    from air_bench.reference import sqair as rsqair
    from air_bench.reference import synth

    cfg = copy.deepcopy(layout.load("configs", "sqair_k5")["config"])
    cfg["train"]["batch_size"] = BATCH
    seqs = layout.kind("sequences")
    bank = synth.digit_bank(cfg["data"]["digit_size"], cuda)
    state = seqs.train_state(cfg, seed, cuda)
    assert sorted(n for n, _ in state.model.named_parameters()) == \
        sorted(rsqair.param_shapes(cfg))
    return cfg, bank, state


def test_sqair_chunk_graph_equals_eager(cuda):
    from attend_infer_repeat_torch.utils import debug_mode

    cfg, bank, graphed = setup(cuda, 11)
    _, _, eager = setup(cuda, 11)
    c = program.config(cfg)
    scan = program.air().make_scan_train_step(c, graphed.model, bank, 2)
    eager_scan = program.air().make_scan_train_step(c, eager.model, bank, 2)
    for _ in range(2):
        graphed, got = scan(graphed)
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
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.utils import debug_mode

    cfg, bank, state = setup(cuda, 5)
    frames, n = cfg["sequence"]["frames"], cfg["model"]["max_steps"]
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, 2)
    before = (st_kernel.launches, st_kernel.bwd_launches)
    with debug_mode(nans=False):
        state, rows = scan(state)
    torch.cuda.synchronize()
    fwd = (st_kernel.launches - before[0]) / 2
    bwd = (st_kernel.bwd_launches - before[1]) / 2
    assert fwd == 1 + 5 * frames * n, fwd
    assert bwd == 5 * frames * n - n, bwd
