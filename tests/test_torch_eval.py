"""PyTorch port: evaluation against the JAX package.

``evaluate``'s averages and ``make_iwae_eval_step``'s five keys on the same
weights, batches and noise (the JAX draws regenerated from its keys,
presence uniforms binarized so that no sample can flip); the metrics
logger's rows and lines; figures and the confusion matrix.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.convert import params_from_flax
from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn
from attend_infer_repeat_torch.eval import (
    MetricsLogger,
    count_confusion,
    evaluate,
    format_confusion,
    make_fig,
    make_iwae_eval_step,
)
from attend_infer_repeat_torch.eval.metrics import host_scalars
from attend_infer_repeat_torch.train import create_train_state, make_eval_step
from attend_infer_repeat_torch.utils import graphs
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.eval import iwae as jiwae
from attend_infer_repeat_tpu.eval import metrics as jmetrics
from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR
from attend_infer_repeat_tpu.train import state as jstate_mod
from attend_infer_repeat_tpu.train import step as jstep_mod
from torch_parity import (
    TINY,
    assert_bit_equal,
    binarized_presence,
    eager_mode,
    forward_noise,
    images,
    to_numpy_tree,
    uncaptured,
)

torch.set_num_threads(1)

BATCH = 6
# f32 end to end; the JAX and the port's forwards sum in other orders
# (measured: evaluate's averages ≤ 2.5e-7 apart relative, the IWAE keys
# ≤ 6.1e-7), so the limit leaves f32 roundoff of longer sums some room
TOL = dict(rtol=2e-5, atol=1e-5)


def configs(**model):
    kw = dict(model=dict(TINY, explore_eps=0.05, **model),
              prior=dict(anneal_start=1, anneal_steps=4))

    def make(mod):
        return mod.Config(model=mod.ModelConfig(**kw["model"]),
                          prior=mod.PriorAnnealConfig(**kw["prior"]),
                          train=mod.TrainConfig(batch_size=BATCH))
    return make(jcfg), make(tcfg)


@pytest.fixture(scope="module")
def paired():
    """JAX config/model/state at step 3 and the port's state with the same
    parameters."""
    jc, tc = configs()
    jm = JaxAIR(jc.model, use_baseline=True)
    jstate = jstate_mod.create_train_state(
        jc, jm, jnp.asarray(images(BATCH)), seed=0).replace(
            step=jnp.asarray(3, jnp.int32))
    state = create_train_state(tc, device="cpu")
    state.model.load_state_dict(params_from_flax(to_numpy_tree(
        jstate.params)))
    state.step = 3
    return jc, tc, jm, jstate, state


def batches(n):
    for i in range(n):
        nums = np.random.default_rng(50 + i).integers(0, 3, BATCH)
        yield images(BATCH, seed=50 + i), nums.astype(np.int32)


def test_evaluate_averages_match_jax(paired):
    """Three batches: every averaged metric within TOL of JAX's."""
    jc, tc, jm, jstate, state = paired
    key = jax.random.key(7)
    with binarized_presence():
        ref = jmetrics.evaluate(
            jstep_mod.make_eval_step(jc, jm), jstate,
            ((jnp.asarray(x), jnp.asarray(n)) for x, n in batches(3)), key)
    eval_step = make_eval_step(tc, state.model)
    calls = []

    def with_jax_noise(st, imgs, nums, generator):
        # batch i of the pass gets the JAX draws of fold_in(key, i)
        i = len(calls)
        calls.append(generator)
        noise = forward_noise(jc.model, jax.random.fold_in(key, i), BATCH,
                              binarize=True)
        return eval_step(st, imgs, nums, noise=noise)

    ours = evaluate(with_jax_noise, state,
                    ((torch.from_numpy(x), torch.from_numpy(n))
                     for x, n in batches(3)), (11, 3))
    assert len(calls) == 3 and sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, err_msg=k, **TOL)
    # the generators are a function of (seed..., batch index)
    again = [torch.rand(2, generator=g).tolist() for g in calls]
    assert again[0] != again[1]


@pytest.mark.parametrize("k", [2, 5])
def test_iwae_eval_step_matches_jax(paired, k):
    """The five keys on the same weights and per-particle noise; the
    explore floor off in both (the loop's IWAE model)."""
    jc, tc, jm, jstate, state = paired
    key = jax.random.key(8)
    imgs = images(BATCH, seed=70)
    jm_iw = JaxAIR(dataclasses.replace(jc.model, explore_eps=None),
                   use_baseline=True)
    with binarized_presence():
        ref = jiwae.make_iwae_eval_step(jc, jm_iw, k)(
            jstate, jnp.asarray(imgs), key)
    noise = [forward_noise(jc.model, kk, BATCH, binarize=True)
             for kk in jax.random.split(key, k)]
    model = state.model.with_config(
        dataclasses.replace(tc.model, explore_eps=None))
    ours = make_iwae_eval_step(tc, model, k)(state, torch.from_numpy(imgs),
                                             noise=noise)
    assert sorted(ours) == sorted(ref)
    for name, v in ref.items():
        np.testing.assert_allclose(ours[name].item(), float(v),
                                   err_msg=name, **TOL)
    assert ours["n_particles"].item() == k


def test_iwae_runs_particles_along_the_batch(paired):
    """One forward at batch k·B, drawn from the generator; the bound sits
    at or above its own single-sample ELBO mean."""
    _, tc, _, _, state = paired
    seen = []
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[0]))
    try:
        m = make_iwae_eval_step(tc, state.model, 4)(
            state, torch.from_numpy(images(BATCH)),
            torch.Generator().manual_seed(0))
    finally:
        hook.remove()
    assert seen == [4 * BATCH]
    assert np.isfinite(m["iwae_bound"].item()) and m["iwae_gap"].item() > -1e-4


def test_metrics_logger_rows_and_lines_match_jax(tmp_path, capsys):
    metrics = [(10, {"elbo": -100.0, "count_accuracy": 0.5}, "train"),
               (20, {"elbo": -90.0, "kl_steps": 0.25}, "eval"),
               (20, {"accuracy": 0.75, "tv": 0.1, "attempt": 1.0}, "basin")]
    outputs = []
    for mod, d in ((jmetrics, "jax"), (sys.modules[MetricsLogger.__module__],
                                       "torch")):
        logger = mod.MetricsLogger(str(tmp_path / d), use_tensorboard=False)
        for step, m, split in metrics:
            logger.log(step, m, prefix=split)
        logger.close()
        rows = [json.loads(line) for line in
                (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
        for r in rows:
            assert r.pop("wall_s") >= 0.0
        outputs.append((rows, capsys.readouterr().out))
    assert outputs[0] == outputs[1]
    assert outputs[1][0][0] == {"step": 10, "split": "train",
                                "elbo": -100.0, "count_accuracy": 0.5}


def test_host_scalars_copies_once():
    m = {"a": torch.tensor(1.5), "b": torch.tensor(2, dtype=torch.int32),
         "c": torch.tensor(0.25, dtype=torch.bfloat16)}
    assert host_scalars(m) == {"a": 1.5, "b": 2.0, "c": 0.25}
    assert host_scalars({}) == {}


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = tcfg.Config(
        model=tcfg.ModelConfig(**TINY),
        data=tcfg.DataConfig(canvas_size=(24, 24), digit_size=(8, 8)),
        train=tcfg.TrainConfig(batch_size=8))
    bank, _ = load_digit_bank("auto", (8, 8))
    return cfg, create_train_state(cfg, device="cpu"), make_synth_fn(
        cfg.data, bank, device="cpu")


def test_make_fig_takes_tensors(tmp_path, tiny_setup):
    pytest.importorskip("matplotlib")
    cfg, state, synth = tiny_setup
    imgs, nums = synth(4, torch.Generator().manual_seed(3))
    _, outputs = make_eval_step(cfg, state.model)(
        state, imgs, nums, torch.Generator().manual_seed(4))
    path = make_fig(imgs, outputs, str(tmp_path / "fig.png"), n_samples=4,
                    true_nums=nums, max_scale=0.3)
    assert (tmp_path / "fig.png").stat().st_size > 1000
    assert path.endswith("fig.png")


def test_make_fig_needs_matplotlib_only_when_called(monkeypatch, tiny_setup):
    cfg, state, synth = tiny_setup
    imgs, nums = synth(2, torch.Generator().manual_seed(3))
    _, outputs = make_eval_step(cfg, state.model)(state, imgs, nums)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        make_fig(imgs, outputs, "unused.png")


def test_count_confusion(tiny_setup):
    cfg, state, synth = tiny_setup
    eval_step = make_eval_step(cfg, state.model)
    gens = [torch.Generator().manual_seed(i) for i in (11, 12)]
    res = count_confusion(eval_step, state, (synth(32, g) for g in gens),
                          (12,))
    assert res["confusion"].sum() == 64
    assert 0.0 <= res["accuracy"] <= 1.0
    again = count_confusion(eval_step, state, (synth(32, g) for g in (
        torch.Generator().manual_seed(i) for i in (11, 12))), (12,))
    assert np.array_equal(res["confusion"], again["confusion"])
    txt = format_confusion(res)
    assert "overall" in txt and txt.count("\n") == res["confusion"].shape[0] + 2


# -- the log point's eval and IWAE steps as graphs, without the capture ------

def test_graphed_eval_step_equals_eager(paired, uncaptured):
    """``make_eval_step``'s graphed path (its capture stubbed out): metrics
    and every output bit-equal to the eager call from one generator state,
    the generators left in one state, the prior's probability read at each
    call's step, and the results of a call unchanged by the next."""
    _, tc, _, _, state = paired
    eval_step = make_eval_step(tc, state.model)
    imgs = torch.from_numpy(images(BATCH, seed=80))
    nums = np.random.default_rng(80).integers(0, 3, BATCH).astype(np.int32)
    results = []
    for step in (3, 4):
        state.step = step
        a, b = (torch.Generator().manual_seed(step) for _ in range(2))
        got = eval_step(state, imgs, nums, a)
        with eager_mode():
            want = eval_step(state, imgs, nums, b)
        assert_bit_equal(got, want, f"step {step}")
        assert torch.equal(a.get_state(), b.get_state())
        results.append((got, [t.clone() for t in graphs.leaves(got)]))
    state.step = 3
    for got, kept in results:
        assert_bit_equal(graphs.leaves(got), kept)
    # the annealed prior moved between the two calls, through one graph
    assert results[0][0][0]["kl_steps"] != results[1][0][0]["kl_steps"]
    assert len(eval_step.graphs) == 1


def test_graphed_iwae_step_equals_eager(paired, uncaptured):
    _, tc, _, _, state = paired
    model = state.model.with_config(
        dataclasses.replace(tc.model, explore_eps=None))
    iwae = make_iwae_eval_step(tc, model, 3)
    imgs = torch.from_numpy(images(BATCH, seed=81))
    a, b = (torch.Generator().manual_seed(9) for _ in range(2))
    got = iwae(state, imgs, a)
    with eager_mode():
        want = iwae(state, imgs, b)
    assert_bit_equal(got, want)
    assert torch.equal(a.get_state(), b.get_state())
    kept = {k: v.clone() for k, v in got.items()}
    iwae(state, imgs, torch.Generator().manual_seed(10))
    assert_bit_equal(got, kept)
    noise = [state.model.sample_noise(BATCH, torch.Generator().manual_seed(j))
             for j in range(3)]
    got = iwae(state, imgs, noise=noise)
    with eager_mode():
        assert_bit_equal(got, iwae(state, imgs, noise=noise))
    assert len(iwae.graphs) == 1
