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
