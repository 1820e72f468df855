"""PyTorch port: the K-step train chunk as a replayed CUDA graph, against
the same steps run eagerly, on the card.

Needs a CUDA card and ``nvcc``; every test skips without a card.  Run on
the card without the JAX package's conftest (the card's machine has no
JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graph_cuda.py

A graph replays the kernels that the eager step launches, on the same
inputs, with the same generator streams (re-seeded per replay), so the
results are held bit for bit: parameters, optimizer state, counts and
every metric row.  The tiny model keeps these quick; ``chip_smoke.py``
runs the same comparison at ``canonical_fast``'s full width.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.utils import graphs

pytestmark = pytest.mark.cuda

K = 4


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

    return load_digit_bank("auto", digit_size=(8, 8))[0]


def tiny_config(remat=None, **train) -> tcfg.Config:
    """A tiny model whose schedules move every step (kl warm-up, cosine
    lr, the prior anneal), so a replay that reused a value would show."""
    return tcfg.Config(
        model=tcfg.ModelConfig(
            img_size=(24, 24), glimpse_size=(10, 10), n_what=4, max_steps=3,
            rnn_hidden=16, encoder_hidden=(16,),
            glimpse_encoder_hidden=(16,), decoder_hidden=(16,),
            transform_hidden=(16,), steps_hidden=(8,),
            baseline_hidden=(16,), remat=remat is not None,
            remat_policy=remat or "full"),
        data=tcfg.DataConfig(canvas_size=(24, 24), digit_size=(8, 8)),
        train=tcfg.TrainConfig(**dict(dict(
            batch_size=16, learning_rate=1e-3, lr_decay_steps=20,
            kl_warmup_steps=6, scan_steps=K), **train)),
        prior=tcfg.PriorAnnealConfig(anneal_start=1, anneal_steps=8))


def arrays(state):
    out = {k: v.clone() for k, v in state.model.state_dict().items()}
    for g, st in state.opt_state.items():
        for kind in ("nu", "trace"):
            for i, t in enumerate(getattr(st, kind)):
                out[f"{g}/{kind}/{i}"] = t.clone()
    return out


def assert_same_state(a, b):
    assert a.step == b.step
    assert {g: s.count for g, s in a.opt_state.items()} == \
        {g: s.count for g, s in b.opt_state.items()}
    x, y = arrays(a), arrays(b)
    differ = [k for k in x if not torch.equal(x[k], y[k])]
    assert not differ, differ[:5]


def eager_chunks(cfg, state, bank, n_chunks):
    from attend_infer_repeat_torch.train import make_train_step

    step = make_train_step(cfg, state.model, digit_bank=bank)
    chunks = []
    for _ in range(n_chunks):
        rows = []
        for _ in range(K):
            state, m = step(state)
            rows.append(m)
        chunks.append({k: torch.stack([m[k] for m in rows]) for k in rows[0]})
    return state, chunks


@pytest.mark.parametrize("case", [
    dict(), dict(remat="save_st"), dict(objective="iwae", iwae_particles=2,
                                        use_baseline=False),
    dict(advantage_norm=True, grad_clip_norm=1.0, log_grad_norms=True)],
    ids=["elbo", "remat_save_st", "iwae", "advantage_norm_clip"])
def test_graph_chunks_equal_eager_steps(cuda, bank, case):
    """Two graphed K-step chunks from a fresh state equal 2·K eager steps
    from the same state, bit for bit; the graph counts its replays."""
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step)

    case = dict(case)
    remat = case.pop("remat", None)
    cfg = tiny_config(remat, **case)
    graphed = create_train_state(cfg, seed=3)
    eager = create_train_state(cfg, seed=3)
    scan = make_scan_train_step(cfg, graphed.model, bank, K)
    st_kernel.launches = st_kernel.bwd_launches = 0
    chunks = []
    for _ in range(2):
        graphed, m = scan(graphed)
        chunks.append(m)
    torch.cuda.synchronize()
    per_step = 1 + 2 * cfg.model.max_steps * (
        cfg.train.iwae_particles if cfg.train.objective == "iwae" else 1)
    # 3 warm-up steps run eagerly, then 2·K replays
    assert st_kernel.launches == (3 + 2 * K) * per_step
    eager, eager_ms = eager_chunks(cfg, eager, bank, 2)
    assert_same_state(graphed, eager)
    for got, want in zip(chunks, eager_ms):
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == (K,)
            assert torch.equal(got[k], want[k]), k
    # the schedules moved inside the chunk: no replay reused a value
    assert len(set(chunks[1]["prior_success_prob"].tolist())) == K


def test_graph_resume_is_bit_equal(cuda, bank, tmp_path):
    """A chunk, a checkpoint, a restore into a fresh state and a chunk
    through a new graph equal two chunks through one graph."""
    from attend_infer_repeat_torch.train import (
        CheckpointManager, create_train_state, make_scan_train_step)

    cfg = tiny_config("save_st")
    whole = create_train_state(cfg, seed=5)
    scan = make_scan_train_step(cfg, whole.model, bank, K)
    for _ in range(2):
        whole, _ = scan(whole)

    part = create_train_state(cfg, seed=5)
    part, _ = make_scan_train_step(cfg, part.model, bank, K)(part)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(part)
    resumed = create_train_state(cfg, seed=99)
    ckpt.restore(resumed)
    assert resumed.step == K
    resumed, _ = make_scan_train_step(cfg, resumed.model, bank, K)(resumed)
    assert_same_state(resumed, whole)


def test_graph_refuses_rebound_state(cuda, bank):
    """The graph holds the optimizer state's addresses: a state whose
    tensors were replaced raises instead of training stale buffers."""
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step)

    cfg = tiny_config()
    state = create_train_state(cfg, seed=0)
    scan = make_scan_train_step(cfg, state.model, bank, K)
    state, _ = scan(state)
    state.opt_state["model"].nu = [t.clone()
                                   for t in state.opt_state["model"].nu]
    with pytest.raises(ValueError, match="captured"):
        scan(state)


def test_debug_mode_runs_the_chunk_eagerly(cuda, bank):
    """Inside ``debug_mode`` the K steps run eagerly (no capture: no
    warm-up launches) and equal the graphed chunk."""
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step)
    from attend_infer_repeat_torch.utils import debug_mode

    cfg = tiny_config()
    a, b = create_train_state(cfg, seed=1), create_train_state(cfg, seed=1)
    st_kernel.launches = 0
    with debug_mode(nans=False):
        a, ma = make_scan_train_step(cfg, a.model, bank, K)(a)
    assert st_kernel.launches == K * (1 + 2 * cfg.model.max_steps)
    b, mb = make_scan_train_step(cfg, b.model, bank, K)(b)
    assert_same_state(a, b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_train_phase_switch_through_graphs(cuda, tmp_path):
    """``train()`` with the two-phase cap switching at step K: one graph
    per phase over the same parameters, equal to the eager loop."""
    import attend_infer_repeat_torch as air
    from attend_infer_repeat_torch.utils import debug_mode

    base = tiny_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, max_scale=0.45,
                                        max_scale_from_step=K),
        train=dataclasses.replace(base.train, n_iters=3 * K, log_every=K,
                                  save_every=K, fig_every=10 ** 9,
                                  eval_batches=1))
    kw = dict(use_tensorboard=False, save_checkpoints=False)
    graphed = air.train(cfg, workdir=str(tmp_path / "graph"), **kw)
    with debug_mode(nans=False):
        eager = air.train(cfg, workdir=str(tmp_path / "eager"), **kw)
    assert graphed.step == eager.step == 3 * K
    assert_same_state(graphed, eager)
    rows = [json.loads(line) for line in (tmp_path / "graph" /
                                          "metrics.jsonl").read_text()
            .splitlines()]
    assert [(r["step"], r["split"]) for r in rows] == [
        (s, split) for s in (K, 2 * K, 3 * K)
        for split in ("train", "eval", "train_eval")]
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))


# -- the other entry points as graphs: each against its eager call ----------

def assert_bit_equal(got, want):
    a, b = graphs.leaves(got), graphs.leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def graphed_and_eager(fn, args, seed):
    """``fn(*args, generator)`` graphed (twice: the capture's call and a
    replay) and eagerly, each from a generator seeded with ``seed``: all
    bit-equal, every generator left in one state, the first result not
    changed by the later calls.  Returns the graphed result."""
    from attend_infer_repeat_torch.utils import debug_mode

    gens = [torch.Generator("cuda").manual_seed(seed) for _ in range(3)]
    first = fn(*args, gens[0])
    kept = [t.clone() for t in graphs.leaves(first)]
    again = fn(*args, gens[1])
    with debug_mode(nans=False):
        want = fn(*args, gens[2])
    assert_bit_equal(first, want)
    assert_bit_equal(again, want)
    assert_bit_equal(graphs.leaves(first), kept)
    assert all(torch.equal(g.get_state(), gens[2].get_state())
               for g in gens[:2])
    return first


def serving_setup(cuda):
    from attend_infer_repeat_torch.models.air import AIRModel

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, prior=tcfg.get_config("serving").prior)
    model = AIRModel(cfg.model, use_baseline=False, device=cuda, seed=2)
    x = torch.rand((8, 24, 24), generator=torch.Generator().manual_seed(0))
    return cfg, model, x.to(cuda)


@pytest.mark.parametrize("tile", [None, 4])
def test_graphed_infer_equals_eager(cuda, tile):
    """``make_infer_fn`` through its graph (one of the tile's shape,
    replayed per chunk) against the eager call, with the caller's
    generator and with injected noise; a replay counts the launches of
    one captured forward."""
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.serving import make_infer_fn
    from attend_infer_repeat_torch.utils import debug_mode, graphs

    cfg, model, x = serving_setup(cuda)
    infer = make_infer_fn(cfg, model, tile=tile)
    per_forward = 2 * cfg.model.max_steps
    chunks = 1 if tile is None else 8 // tile
    st_kernel.launches = 0
    out = graphed_and_eager(infer, (x,), 1)
    # warm-up, then a replay per chunk in each of the two graphed calls;
    # the eager call launches per chunk
    assert st_kernel.launches == per_forward * (graphs.WARMUP + 3 * chunks)
    assert out["canvas"].shape == (8, 24, 24) and len(infer.graphs) == 1
    noise = model.sample_noise(8, torch.Generator(cuda).manual_seed(2))
    got = infer(x, noise=noise)
    with debug_mode(nans=False):
        assert_bit_equal(got, infer(x, noise=noise))


def test_graphed_generate_and_synthesis_equal_eager(cuda, bank):
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.serving import make_generate_fn

    cfg, model, _ = serving_setup(cuda)
    scenes = graphed_and_eager(make_generate_fn(cfg, model, 0.5), (8,), 3)
    assert scenes.shape == (8, 24, 24)
    for placement in ("grid", "uniform"):
        data = dataclasses.replace(cfg.data, placement=placement)
        imgs, nums = graphed_and_eager(make_synth_fn(data, bank), (8,), 4)
        assert imgs.shape == (8, 24, 24) and nums.dtype == torch.int32


@pytest.mark.parametrize("source", ["bank", "batch", "noise"])
def test_graphed_single_step_equals_eager(cuda, bank, source):
    """``make_train_step`` through its graph (on-device synthesis, a host
    batch, injected noise) against the eager step, three steps from one
    state: parameters, optimizer state and every metric bit-equal."""
    from attend_infer_repeat_torch.ops import st_kernel
    from attend_infer_repeat_torch.train import (
        create_train_state, make_train_step)
    from attend_infer_repeat_torch.utils import debug_mode, graphs

    cfg = tiny_config()
    graphed = create_train_state(cfg, seed=6)
    eager = create_train_state(cfg, seed=6)
    data = {} if source == "batch" else {"digit_bank": bank}
    step = make_train_step(cfg, graphed.model, **data)
    eager_step = make_train_step(cfg, eager.model, **data)
    rng = np.random.default_rng(6)
    st_kernel.launches = st_kernel.bwd_launches = 0
    for i in range(3):
        batch = noise = None
        if source == "batch":
            batch = (rng.random((16, 24, 24), dtype=np.float32),
                     rng.integers(0, 3, 16).astype(np.int32))
        if source == "noise":
            noise = graphed.model.sample_noise(
                16, torch.Generator(cuda).manual_seed(i))
        graphed, got = step(graphed, batch, noise)
        with debug_mode(nans=False):
            eager, want = eager_step(eager, batch, noise)
        assert_bit_equal(got, want)
    assert_same_state(graphed, eager)
    per_step = 2 * cfg.model.max_steps
    synth = 0 if source == "batch" else 1
    assert st_kernel.bwd_launches == per_step * (graphs.WARMUP + 6)
    assert st_kernel.launches == (per_step + synth) * (graphs.WARMUP + 6)
    assert len(step.graphs) == 1


def test_graphed_eval_and_iwae_equal_eager(cuda, bank):
    """``make_eval_step`` and ``make_iwae_eval_step`` through their graphs
    against the eager calls, at two steps (the annealed prior is a device
    input: one graph serves both)."""
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.eval import make_iwae_eval_step
    from attend_infer_repeat_torch.train import (
        create_train_state, make_eval_step)

    cfg = tiny_config()
    state = create_train_state(cfg, seed=7)
    imgs, nums = make_synth_fn(cfg.data, bank)(
        16, torch.Generator(cuda).manual_seed(5))
    eval_step = make_eval_step(cfg, state.model)
    iwae = make_iwae_eval_step(cfg, state.model.with_config(
        dataclasses.replace(cfg.model, explore_eps=None)), 3)
    kl = []
    for step in (2, 5):
        state.step = step
        metrics, _ = graphed_and_eager(
            lambda g: eval_step(state, imgs, nums, g), (), step)
        graphed_and_eager(lambda g: iwae(state, imgs, g), (), 10 + step)
        kl.append(metrics["kl_steps"].item())
    assert kl[0] != kl[1]
    assert len(eval_step.graphs) == len(iwae.graphs) == 1


def test_graphed_infer_refuses_replaced_parameters(cuda):
    from attend_infer_repeat_torch.serving import make_infer_fn

    cfg, model, x = serving_setup(cuda)
    infer = make_infer_fn(cfg, model)
    infer(x)
    model.decoder.mlp.dense[0].weight = torch.nn.Parameter(
        model.decoder.mlp.dense[0].weight.detach().clone())
    with pytest.raises(ValueError, match="captured"):
        infer(x)


def test_capture_names_a_host_sync(cuda):
    """An operation that waits for the card raises in the last warm-up
    run, before capture, with the operation named."""
    from attend_infer_repeat_torch.utils import graphs

    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError,
                       match="_local_scalar_dense.*waits for the card"):
        graphs.Graph(lambda: x * x.sum().item(), cuda)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_failed_capture_raises_and_leaves_the_generators_usable(cuda):
    """An operation that only the capture meets (here one that waits for
    the card) raises out of ``Graph``; the default generator and a
    registered one draw as before it."""
    from attend_infer_repeat_torch.utils import graphs

    x = torch.ones(4, device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)

    def body():
        y = x * torch.rand(4, device=cuda, generator=gen) + torch.rand(
            4, device=cuda)
        if torch.cuda.is_current_stream_capturing():
            y.sum().item()
        return y

    with pytest.raises(RuntimeError):
        graphs.Graph(body, cuda, generators=[gen])
    draws = []
    for _ in range(2):
        torch.manual_seed(0)
        gen.manual_seed(3)
        draws.append((torch.rand(4, device=cuda),
                      torch.rand(4, device=cuda, generator=gen)))
    assert all(torch.equal(u, v) for u, v in zip(*draws))


def test_spans_stay_on_the_host(cuda, bank):
    """Under a profiler that traces the card, a graphed chunk and a
    graphed request show the program's spans as host ranges, and no
    device event carries a span's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from attend_infer_repeat_torch.serving import make_infer_fn
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step)
    from attend_infer_repeat_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CUDA]):    # CUPTI up first
        torch.ones(1, device=cuda).add_(1)
    cfg = tiny_config()
    state = create_train_state(cfg, seed=3)
    scan = make_scan_train_step(cfg, state.model, bank, K)
    serving, model, x = serving_setup(cuda)
    infer = make_infer_fn(serving, model)
    gen = torch.Generator(cuda).manual_seed(1)
    state, _ = scan(state)
    infer(x, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = scan(state)
        infer(x, gen)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    host = [e.name() for e in events if e.device_type() != DeviceType.CUDA
            and e.name().startswith(profiling.PREFIX)]
    assert device and not [n for n in device
                           if n.startswith(profiling.PREFIX)]
    names = {f"air.{n}" for n in (
        "train.steps", "train.prepare", "train.seed", "graph.launch",
        "serve.infer", "serve.noise", "graphs.lookup", "graphs.fill",
        "graphs.copy_out")}
    assert set(host) == names
    assert host.count("air.graph.launch") == K + 1
    assert host.count("air.train.seed") == K
