"""PyTorch port: checkpoints of the ``TrainState`` (``train/checkpoint.py``)
and resume through the loop, bit for bit; the JAX package's checkpoint
tests (``tests/test_train.py``) ported."""

import os

import pytest
import torch

from attend_infer_repeat_torch.data import load_digit_bank
from attend_infer_repeat_torch.train import (
    BestCheckpointTracker,
    CheckpointManager,
    create_train_state,
    make_train_step,
    restore_latest,
    train,
)
from test_torch_train import tiny_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bank():
    imgs, _ = load_digit_bank("auto", digit_size=(8, 8))
    return imgs


@pytest.fixture
def setup():
    cfg = tiny_config()
    return cfg, create_train_state(cfg, device="cpu")


def arrays(state):
    """Parameters and optimizer state, by name."""
    out = {f"model/{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    for g, st in state.opt_state.items():
        for kind in ("nu", "trace"):
            for i, t in enumerate(getattr(st, kind)):
                out[f"{g}/{kind}/{i}"] = t.clone()
    return out


def assert_same_state(a, b):
    assert a.step == b.step and a.base_seed == b.base_seed
    assert {g: s.count for g, s in a.opt_state.items()} == \
        {g: s.count for g, s in b.opt_state.items()}
    xa, xb = arrays(a), arrays(b)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert torch.equal(xa[k], xb[k]), k


def test_save_restore_continue_is_bitwise(tmp_path, setup, bank):
    """Restore into a fresh template and continue: the same metrics and
    parameters as continuing the original (step, RNG stream, anneal
    position and both optimizer groups all restored)."""
    cfg, state = setup
    step = make_train_step(cfg, state.model, digit_bank=bank)
    for _ in range(3):
        state, _ = step(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(state, force=True)
    saved = arrays(state)
    state, m_cont = step(state)

    template = create_train_state(cfg, seed=123, device="cpu")
    restored = mgr.restore(template)
    assert restored is template and restored.step == 3
    assert restored.base_seed == cfg.train.seed
    for k, v in arrays(restored).items():
        assert torch.equal(v, saved[k]), k
    restored, m_res = make_train_step(cfg, restored.model,
                                      digit_bank=bank)(restored)
    assert m_cont["elbo"].item() == m_res["elbo"].item()
    assert_same_state(state, restored)


def test_periodic_save_rules_and_pruning(tmp_path, setup):
    cfg, state = setup
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                            save_interval_steps=2)
    saved = []
    for s in range(1, 8):
        state.step = s
        saved.append(mgr.save(state))
    assert saved == [False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    state.step = 5
    assert not mgr.save(state)             # behind the latest
    assert mgr.save(state, force=True)     # forced: written, 4 pruned
    assert mgr.all_steps() == [5, 6]
    with pytest.raises(FileExistsError):
        mgr.save(state, force=True)
    # a hidden temporary directory (a save cut by a kill) is not a step
    os.makedirs(tmp_path / "ckpt" / ".tmp-9-1")
    assert mgr.all_steps() == [5, 6]
    mgr.wait()
    mgr.close()


def test_best_checkpoint_tracker(tmp_path, setup, bank):
    """Only improvements snapshot; the best step (not the latest)
    restores; the sidecar makes the tracker resume-safe."""
    cfg, state = setup
    step = make_train_step(cfg, state.model, digit_bank=bank)
    snaps = []
    for _ in range(3):
        state, _ = step(state)
        snaps.append((state.step, arrays(state)))

    d = str(tmp_path / "ckpt_best")
    tr = BestCheckpointTracker(d)
    state.step = 1
    assert tr.offer(state, 0.50)             # the first value always
    state.step = 2
    assert not tr.offer(state, 0.40)         # worse: ignored
    state.step = 3
    assert tr.offer(state, 0.75)             # better: replaces
    assert not tr.offer(state, 0.75)         # same step, same value
    assert tr.offer(state, 0.90)             # same step, strictly better
    tr.wait()
    tr.close()
    assert sorted(os.listdir(d)) == ["3", "best.json"]

    tr2 = BestCheckpointTracker(d)
    assert tr2.best == pytest.approx(0.90) and tr2.best_step == 3
    state.step = 2
    assert not tr2.offer(state, 0.60)        # a resume never regresses
    restored = tr2.restore(create_train_state(cfg, seed=5, device="cpu"))
    assert restored.step == 3
    for k, v in arrays(restored).items():
        assert torch.equal(v, snaps[2][1][k]), k


def test_best_tracker_keeps_the_best_below_a_later_step(tmp_path, setup):
    """A better value at a lower step than the old best (a resumed run
    whose best was saved later) replaces it."""
    cfg, state = setup
    tr = BestCheckpointTracker(str(tmp_path / "b"))
    state.step = 5
    assert tr.offer(state, 0.3)
    state.step = 2
    assert tr.offer(state, 0.6)
    assert tr._mgr.all_steps() == [2]
    assert tr.restore(create_train_state(cfg, device="cpu")).step == 2


def test_checkpoint_manager_fresh_wipes_stale_run(tmp_path, setup):
    cfg, state = setup
    state.step = 1
    d = str(tmp_path / "ckpt")
    assert CheckpointManager(d).save(state)
    m2 = CheckpointManager(d, fresh=True)
    assert m2.restore(create_train_state(cfg, device="cpu")) is None
    assert m2.save(state, force=True)        # the same step: no collision
    assert m2.restore(create_train_state(cfg, device="cpu")).step == 1


def test_best_tracker_fresh_wipes_stale_run(tmp_path, setup):
    cfg, state = setup
    state.step = 1
    d = str(tmp_path / "ckpt_best")
    assert BestCheckpointTracker(d).offer(state, 0.90)
    tr2 = BestCheckpointTracker(d, fresh=True)
    assert tr2.best is None and tr2.best_step is None
    assert tr2.offer(state, 0.40)            # lower value, same step
    tr3 = BestCheckpointTracker(d)
    assert tr3.best == pytest.approx(0.40)
    assert tr3.restore(create_train_state(cfg, device="cpu")) is not None


def test_restore_latest(tmp_path, setup):
    cfg, state = setup
    template = create_train_state(cfg, device="cpu")
    assert restore_latest(str(tmp_path / "none"), template) is None
    state.step = 4
    CheckpointManager(str(tmp_path / "c")).save(state)
    assert restore_latest(str(tmp_path / "c"), template).step == 4


def test_loop_resume_is_bitwise(tmp_path):
    """train() to 3 (off the K=2 grid), then a resume to 6, equals train()
    to 6: parameters, both optimizer groups, step and seed, bit for
    bit."""
    cfg = tiny_config(n_iters=6, log_every=2, fig_every=100, save_every=2,
                      eval_batches=1, scan_steps=2)
    kw = dict(use_tensorboard=False, device="cpu")
    whole = train(cfg, workdir=str(tmp_path / "whole"), **kw)
    train(cfg, workdir=str(tmp_path / "res"), n_iters=3, **kw)
    resumed = train(cfg, workdir=str(tmp_path / "res"), **kw)
    assert whole.step == resumed.step == 6
    assert_same_state(whole, resumed)
    # the checkpoint restores on the state's device (here the CPU) into a
    # template of another seed
    template = create_train_state(cfg, seed=9, device="cpu")
    assert_same_state(restore_latest(str(tmp_path / "res" / "ckpt"),
                                     template), whole)
