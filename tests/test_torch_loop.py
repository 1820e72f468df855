"""PyTorch port: the training loop (``train/loop.py``) and its CLI.

The log schedule against the JAX loop's, row for row; then the JAX
package's loop tests (``tests/test_loop.py``) ported: pickle data
(resident and streamed), ``--no-resume``, scan resume onto the grid, the
two-phase cap, basin detect-and-restart with keep-best and its sidecar,
the alignment errors; and a SIGTERM during a CLI run, resumed.
"""

import dataclasses
import glob
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import attend_infer_repeat_torch as air
from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
from attend_infer_repeat_torch.train import train
from attend_infer_repeat_tpu import configs as jcfg
from test_torch_train import tiny_config

torch.set_num_threads(1)

KW = dict(use_tensorboard=False, device="cpu")


def rows_of(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def schedule_config(mod):
    """A tiny config that runs every log-point branch: K=2 chunks, a
    two-phase cap switching at 4, the IWAE bound, and a basin detector at
    4 that restarts once.  ``steps_bias=10`` with 2 digits on every canvas
    makes every attempt's gate read 1.0 in both packages (a presence
    probability of ~1 − 5e-5 at each of the 2 steps), so the restart and
    the keep-best decision do not depend on either package's noise."""
    return mod.Config(
        model=mod.ModelConfig(
            img_size=(14, 14), glimpse_size=(6, 6), n_what=4, max_steps=2,
            rnn_hidden=16, encoder_hidden=(16,),
            glimpse_encoder_hidden=(16,), decoder_hidden=(16,),
            transform_hidden=(16,), steps_hidden=(8,),
            baseline_hidden=(16,), steps_bias=10.0, max_scale=0.5,
            max_scale_from_step=4),
        data=mod.DataConfig(canvas_size=(14, 14), digit_size=(8, 8),
                            min_digits=2, max_digits=2),
        train=mod.TrainConfig(
            batch_size=8, learning_rate=1e-4, n_iters=8, log_every=2,
            fig_every=100, save_every=4, eval_batches=1, scan_steps=2,
            basin_detect_step=4, basin_accuracy_threshold=1.1,
            basin_max_restarts=1, iwae_eval_particles=2),
        prior=mod.PriorAnnealConfig(anneal_start=2, anneal_steps=10))


def test_log_schedule_matches_jax(tmp_path):
    """The same sequence of (step, split) rows in metrics.jsonl, and the
    same restart sidecar, from both packages' train()."""
    from attend_infer_repeat_tpu.train.loop import train as jax_train

    jax_train(schedule_config(jcfg), workdir=str(tmp_path / "jax"),
              use_tensorboard=False, save_checkpoints=False)
    train(schedule_config(tcfg), workdir=str(tmp_path / "torch"),
          save_checkpoints=False, **KW)
    ref, ours = rows_of(tmp_path / "jax"), rows_of(tmp_path / "torch")
    sched = [(r["step"], r["split"]) for r in ours]
    assert sched == [(r["step"], r["split"]) for r in ref]
    assert [r for r in ours if r["split"] == "basin"] and \
        sched.count((4, "basin")) == 2 and (8, "iwae") in sched
    # the same keys, but for the loss, which the port's step also reports
    assert [sorted(set(r) - {"loss"}) for r in ours] == \
        [sorted(r) for r in ref]
    assert all("loss" in r for r in ours if r["split"] == "train")
    side = [json.loads((tmp_path / d / "restarts.json").read_text())
            for d in ("jax", "torch")]
    for s in side:
        s.pop("trigger_tv")
    assert side[0] == side[1] and side[1]["attempt"] == 1
    assert all(np.isfinite(v) for r in ours for v in r.values()
               if isinstance(v, float))


@pytest.mark.parametrize("resident", [True, False],
                         ids=["device-resident", "host-streamed"])
def test_train_loop_from_pickle(tmp_path, resident):
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=4,
                      save_every=100, eval_batches=1)
    bank, _ = load_digit_bank("auto", digit_size=cfg.data.digit_size)
    imgs, nums = make_synth_fn(cfg.data, bank, device="cpu")(
        32, torch.Generator().manual_seed(0))
    path = tmp_path / "train.pickle"
    with open(path, "wb") as f:
        pickle.dump({"imgs": imgs.numpy(), "nums": nums.numpy()}, f)
    state = train(cfg, workdir=str(tmp_path / "run"), save_checkpoints=False,
                  data_path=str(path), resident_data=resident, **KW)
    assert state.step == 4
    rows = rows_of(tmp_path / "run")
    assert [(r["step"], r["split"]) for r in rows] == [
        (s, sp) for s in (2, 4) for sp in ("train", "eval", "train_eval")]
    assert all(np.isfinite(r["elbo"]) for r in rows if "elbo" in r)


def test_train_loop_no_resume_restarts_cleanly(tmp_path):
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=100,
                      save_every=2, eval_batches=1)
    workdir = str(tmp_path / "run")
    assert train(cfg, workdir=workdir, **KW).step == 4
    with open(os.path.join(workdir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"step": 999999, "split": "train",
                            "sentinel": 1.0}) + "\n")
    stale_fig = os.path.join(workdir, "fig_9999999.png")
    with open(stale_fig, "wb") as f:
        f.write(b"stale")
    os.makedirs(os.path.join(workdir, "tb"))
    state2 = train(cfg, workdir=workdir, resume=False, **KW)
    assert state2.step == 4
    ckpts = sorted(int(os.path.basename(p)) for p in
                   glob.glob(os.path.join(workdir, "ckpt", "*"))
                   if os.path.basename(p).isdigit())
    assert ckpts == [2, 4]
    rows = rows_of(workdir)
    assert not any(r.get("sentinel") for r in rows)
    assert max(r["step"] for r in rows) <= 4
    assert not os.path.exists(stale_fig)
    assert not os.path.exists(os.path.join(workdir, "tb"))


def test_train_loop_scan_resume_realigns_to_grid(tmp_path):
    workdir = str(tmp_path / "run")
    cfg = tiny_config(n_iters=3, log_every=2, fig_every=100, save_every=2,
                      eval_batches=1, scan_steps=2)
    assert train(cfg, workdir=workdir, **KW).step == 3
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, n_iters=7))
    assert train(cfg2, workdir=workdir, **KW).step == 7
    logged = {r["step"] for r in rows_of(workdir) if r["split"] == "train"}
    assert {4, 6, 7} <= logged, logged
    ckpts = {int(os.path.basename(p)) for p in
             glob.glob(os.path.join(workdir, "ckpt", "*"))
             if os.path.basename(p).isdigit()}
    assert {4, 6} <= ckpts, ckpts


def test_train_loop_end_to_end(tmp_path):
    """Every split logged, a figure drawn, checkpoints and the best
    checkpoint written; a resume continues past the old end."""
    pytest.importorskip("matplotlib")
    cfg = tiny_config(n_iters=6, log_every=2, fig_every=6, save_every=3,
                      eval_batches=2, scan_steps=1, iwae_eval_particles=2)
    workdir = str(tmp_path / "run")
    assert train(cfg, workdir=workdir, **KW).step == 6
    rows = rows_of(workdir)
    assert {r["split"] for r in rows} == {"train", "eval", "train_eval",
                                          "iwae"}
    assert all(r["iwae_bound"] >= r["elbo"] - 1.0 for r in rows
               if r["split"] == "iwae")
    assert glob.glob(os.path.join(workdir, "fig_0000006.png"))
    best = json.load(open(os.path.join(workdir, "ckpt_best", "best.json")))
    assert os.path.isdir(os.path.join(workdir, "ckpt_best",
                                      str(best["step"])))
    assert train(cfg, workdir=workdir, n_iters=8, **KW).step == 8
    assert max(r["step"] for r in rows_of(workdir)) == 8
    assert len([r for r in rows_of(workdir) if r["step"] == 2]) == 4


def test_figures_disabled_once_without_matplotlib(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=2, save_every=100,
                      eval_batches=1)
    assert train(cfg, workdir=str(tmp_path / "run"), save_checkpoints=False,
                 **KW).step == 4
    assert capsys.readouterr().out.count("figures disabled") == 1
    assert not glob.glob(str(tmp_path / "run" / "fig_*.png"))


def test_two_phase_max_scale_cap(tmp_path):
    """Before the boundary the capless model trains (bitwise the
    ``max_scale=None`` run); from it the cap binds (1e-6 must change the
    trajectory).  Both phases update the same parameters."""
    def mk(max_scale, from_step):
        cfg = tiny_config(log_every=100, fig_every=100, save_every=100,
                          eval_batches=1)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, max_scale=max_scale, max_scale_from_step=from_step))

    kw = dict(save_checkpoints=False, **KW)

    def params(state):
        return [p.detach().clone() for p in state.model.parameters()]

    free = train(mk(None, 0), workdir=str(tmp_path / "a"), n_iters=2, **kw)
    twop = train(mk(1e-6, 2), workdir=str(tmp_path / "b"), n_iters=2, **kw)
    assert all(torch.equal(x, y) for x, y in zip(params(free), params(twop)))
    assert twop.model.cfg.max_scale == 1e-6      # the config's own model
    free4 = train(mk(None, 0), workdir=str(tmp_path / "c"), n_iters=4, **kw)
    twop4 = train(mk(1e-6, 2), workdir=str(tmp_path / "d"), n_iters=4, **kw)
    assert max((x - y).abs().max().item()
               for x, y in zip(params(free4), params(twop4))) > 0.0
    assert twop4.opt_state["model"].count == 4


def test_two_phase_cap_requires_scan_alignment(tmp_path):
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=2, save_every=2,
                      eval_batches=1, scan_steps=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, max_scale=0.5, max_scale_from_step=3))
    with pytest.raises(ValueError, match="max_scale_from_step"):
        train(cfg, workdir=str(tmp_path / "bad"), save_checkpoints=False,
              **KW)
    cfg = tiny_config(n_iters=4, log_every=3, scan_steps=2)
    with pytest.raises(ValueError, match="log_every"):
        train(cfg, workdir=str(tmp_path / "bad2"), save_checkpoints=False,
              **KW)


def test_basin_restart_triggers_reinit_and_finishes(tmp_path):
    """An always-failing gate restarts once (folded seed, sidecar, fresh
    trajectory), then trains the new attempt to the end; keep-best
    replays attempt 0 iff its gate read was better."""
    cfg = tiny_config(n_iters=6, log_every=2, fig_every=100, save_every=2,
                      eval_batches=1, basin_detect_step=2,
                      basin_accuracy_threshold=1.1, basin_max_restarts=1)
    workdir = str(tmp_path / "run")
    assert train(cfg, workdir=workdir, **KW).step == 6
    side = json.load(open(os.path.join(workdir, "restarts.json")))
    assert side["attempt"] in (1, 2)
    assert side["replay"] == (side["attempt"] == 2)
    assert side["trigger_step"] == 2 and 0.0 <= side["trigger_tv"] <= 1.0
    rows = rows_of(workdir)
    basin = [r for r in rows if r["split"] == "basin"]
    attempts = [r["attempt"] for r in basin]
    assert attempts[:2] == [0.0, 1.0] and len(basin) in (2, 3)
    if len(basin) == 3:
        assert attempts[2] == 2.0
        assert basin[0]["accuracy"] > basin[1]["accuracy"]
        assert basin[2]["accuracy"] == basin[0]["accuracy"]
    else:
        assert basin[1]["accuracy"] >= basin[0]["accuracy"]
    step2 = [r["elbo"] for r in rows
             if r["split"] == "train" and r["step"] == 2]
    assert len(step2) == len(basin) and step2[0] != step2[1]
    assert any(r["step"] == 6 for r in rows if r["split"] == "train")
    # the restart wiped the abandoned attempt's checkpoints
    ckpts = sorted(int(os.path.basename(p)) for p in
                   glob.glob(os.path.join(workdir, "ckpt", "*"))
                   if os.path.basename(p).isdigit())
    assert ckpts == [2, 4, 6]


def test_basin_keep_best_replays_the_better_attempt(tmp_path, monkeypatch):
    """Exhausted restarts with a better earlier attempt: the loop replays
    that attempt's seed (attempt = max_restarts + 1) and the replay reads
    the same gate as the attempt it replays, bit for bit."""
    from attend_infer_repeat_torch.eval import metrics

    # attempt 0 reads its real accuracy; attempt 1 reads 0 (forced)
    seen = []
    real = metrics.evaluate

    def evaluate(eval_step, state, batches, seed):
        out = real(eval_step, state, batches, seed)
        if seed[0] == 1 and state.base_seed == 7919:
            out["count_accuracy_mode"] = 0.0
        seen.append((state.base_seed, out["count_accuracy_mode"]))
        return out

    monkeypatch.setattr("attend_infer_repeat_torch.train.loop.evaluate",
                        evaluate)
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=100, save_every=100,
                      eval_batches=1, basin_detect_step=2,
                      basin_accuracy_threshold=1.1, basin_max_restarts=1)
    workdir = str(tmp_path / "run")
    train(cfg, workdir=workdir, save_checkpoints=False, **KW)
    basin = [r for r in rows_of(workdir) if r["split"] == "basin"]
    side = json.load(open(os.path.join(workdir, "restarts.json")))
    assert basin[0]["accuracy"] > 0.0          # 0.25 with these seeds
    assert [r["attempt"] for r in basin] == [0.0, 1.0, 2.0]
    assert side == dict(side, attempt=2, seed=0, replay=True)
    assert basin[2]["accuracy"] == basin[0]["accuracy"]
    assert (7919, 0.0) in seen and seen[0][0] == 0


def test_basin_detector_logs_but_keeps_good_run(tmp_path):
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=100, save_every=100,
                      eval_batches=1, basin_detect_step=2,
                      basin_accuracy_threshold=-1.0, basin_max_restarts=3)
    workdir = str(tmp_path / "run")
    assert train(cfg, workdir=workdir, save_checkpoints=False,
                 **KW).step == 4
    assert not os.path.exists(os.path.join(workdir, "restarts.json"))
    rows = rows_of(workdir)
    basin = [r for r in rows if r["split"] == "basin"]
    assert len(basin) == 1 and basin[0]["attempt"] == 0.0
    assert len([r for r in rows
                if r["split"] == "train" and r["step"] == 2]) == 1


def test_basin_detect_requires_log_alignment(tmp_path):
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=100, save_every=100,
                      eval_batches=1, basin_detect_step=3)
    with pytest.raises(ValueError, match="basin_detect_step"):
        train(cfg, workdir=str(tmp_path / "bad"), save_checkpoints=False,
              **KW)


def test_basin_restart_sidecar_resumes_as_itself(tmp_path):
    """Died after a restart, before the new attempt's first save: the
    sidecar alone makes the resume rebuild attempt 1's seed."""
    cfg = tiny_config(n_iters=4, log_every=2, fig_every=100, save_every=100,
                      eval_batches=1, basin_detect_step=2,
                      basin_accuracy_threshold=1.1, basin_max_restarts=1)
    workdir = str(tmp_path / "run")
    train(cfg, workdir=workdir, save_checkpoints=False, **KW)
    assert json.load(open(os.path.join(workdir, "restarts.json")))[
        "attempt"] == 1
    step2 = [r["elbo"] for r in rows_of(workdir)
             if r["split"] == "train" and r["step"] == 2]
    assert len(step2) == 2
    train(cfg, workdir=workdir, save_checkpoints=False, resume=True, **KW)
    after = [r["elbo"] for r in rows_of(workdir)
             if r["split"] == "train" and r["step"] == 2]
    assert len(after) == 3 and after[2] == step2[1] != step2[0]
    assert json.load(open(os.path.join(workdir, "restarts.json")))[
        "attempt"] == 1


def test_air_train_is_callable_after_importing_the_subpackage(tmp_path):
    import attend_infer_repeat_torch.train as train_pkg

    assert callable(air.train) and callable(train_pkg)
    cfg = tiny_config(n_iters=1, log_every=1, fig_every=100, save_every=100,
                      eval_batches=1)
    state = air.train(cfg, workdir=str(tmp_path / "run"),
                      save_checkpoints=False, **KW)
    assert state.step == 1
    assert air.CheckpointManager is train_pkg.CheckpointManager
    assert callable(air.evaluate) and callable(air.make_iwae_eval_step)
    assert air.MetricsLogger.__module__.endswith("eval.metrics")
    assert callable(air.BestCheckpointTracker) and callable(
        air.restore_latest)


def test_train_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(tiny_config(n_iters=1), workdir=str(tmp_path / "run"),
              use_tensorboard=False)


def test_cli_sigterm_saves_and_resumes_bitwise(tmp_path):
    """A SIGTERM during a CLI run (``--device cpu``, JAX blocked from
    import) leaves the kill-time checkpoint, printed as such; resuming
    from it ends where an uninterrupted run ends, bit for bit."""
    helper = os.path.join(os.path.dirname(__file__), "helpers",
                          "torch_train_kill_helper.py")
    n_total = 40

    def run(workdir, iters, kill=False):
        cmd = [sys.executable, helper, "--workdir", str(workdir),
               "--iters", str(iters), "--save-every", str(10**8)]
        if kill:
            cmd.append("--kill-after-first-log")
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)

    res_a = run(tmp_path / "a", n_total)
    assert res_a.returncode == 0, res_a.stderr[-2000:]
    assert "JAX modules loaded: []" in res_a.stdout
    assert os.listdir(tmp_path / "a" / "ckpt") == [str(n_total)]

    res_kill = run(tmp_path / "b", 10**6, kill=True)
    assert res_kill.returncode == -15, res_kill.stderr[-2000:]
    m = re.search(r"\[preempt\] signal 15: saved step (\d+)",
                  res_kill.stdout)
    assert m, res_kill.stdout[-2000:]
    kill_step = int(m.group(1))
    assert os.listdir(tmp_path / "b" / "ckpt") == [str(kill_step)]
    assert 1 <= kill_step < n_total

    res_b = run(tmp_path / "b", n_total)
    assert res_b.returncode == 0, res_b.stderr[-2000:]
    assert f"resumed from step {kill_step}" in res_b.stdout
    a = torch.load(tmp_path / "a" / "ckpt" / str(n_total) / "state.pt",
                   weights_only=True)
    b = torch.load(tmp_path / "b" / "ckpt" / str(n_total) / "state.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == n_total
    assert a["base_seed"] == b["base_seed"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for g, st in a["opt_state"].items():
        assert st["count"] == b["opt_state"][g]["count"]
        for x, y in zip(st["nu"] + st["trace"],
                        b["opt_state"][g]["nu"] + b["opt_state"][g]["trace"]):
            assert torch.equal(x, y)


def test_cli_parses_the_jax_surface(tmp_path, monkeypatch):
    """Every JAX flag is accepted; overrides reach train()."""
    from attend_infer_repeat_torch.train import __main__ as cli

    got = {}
    monkeypatch.setattr(cli, "train", lambda config, **kw: got.update(
        config=config, **kw))
    cli.main(["--config", "canonical_fast", "--iters", "3", "--batch-size",
              "4", "--lr", "0.5", "--seed", "7", "--dtype", "float32",
              "--scan-steps", "1", "--no-remat", "--st-method", "pallas",
              "--stream-data", "--no-resume", "--no-tensorboard",
              "--no-checkpoints", "--device", "cpu", "--workdir",
              str(tmp_path)])
    c = got["config"]
    assert (c.train.batch_size, c.train.learning_rate, c.train.seed,
            c.train.scan_steps) == (4, 0.5, 7, 1)
    assert (c.model.dtype, c.model.remat, c.model.st_method) == (
        "float32", False, "pallas")
    assert got["n_iters"] == 3 and got["device"] == "cpu"
    assert not (got["resume"] or got["use_tensorboard"]
                or got["save_checkpoints"] or got["resident_data"])
    assert c.name == "canonical_fast" and tcfg.get_config(c.name)
