"""PyTorch port: the reference workflow's tools (``scripts/torch_*.py``)
against the JAX scripts' own code paths.

``configs.apply_overrides`` against ``scripts/run_variant.py``'s
``_apply``; the evaluator's ``evaluate_checkpoint`` against JAX's
``count_confusion``, ``evaluate`` and ``make_iwae_eval_step`` in the JAX
script's order, on the same weights, batches and noise (the JAX draws
regenerated from its keys, presence uniforms binarized so that no sample
can flip); its restores and its printed keys; the explain-away selection
against the JAX script's; the dataset writer in a subprocess with JAX
blocked, its pickles read by both packages' ``load_data`` and trained on
(resident and streamed); the override runner.  All on the CPU at tiny
width.
"""

import dataclasses
import importlib.util
import json
import math
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.convert import params_from_flax
from attend_infer_repeat_torch.data import load_data
from attend_infer_repeat_torch.eval import make_iwae_eval_step
from attend_infer_repeat_torch.train import (
    create_train_state,
    make_eval_step,
    train,
)
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.data import loader as jloader
from attend_infer_repeat_tpu.data.synth import _pairwise_iou as jax_iou
from attend_infer_repeat_tpu.eval import analyze as janalyze
from attend_infer_repeat_tpu.eval import iwae as jiwae
from attend_infer_repeat_tpu.eval import metrics as jmetrics
from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR
from attend_infer_repeat_tpu.train import state as jstate_mod
from attend_infer_repeat_tpu.train import step as jstep_mod
from torch_parity import (
    TINY,
    binarized_presence,
    forward_noise,
    images,
    to_numpy_tree,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HELPER = ROOT / "tests" / "helpers" / "torch_no_jax_helper.py"
BATCH = 6
# f32 end to end, the limit tests/test_torch_eval.py states for the same
# functions: the two forwards sum in other orders
TOL = dict(rtol=2e-5, atol=1e-5)
# what the JAX script prints of evaluate()'s and the IWAE step's metrics
EVAL_KEYS = ["count_accuracy", "count_accuracy_mode", "elbo", "kl_steps"]
IWAE_KEYS = ["elbo", "iwae_bound", "iwae_gap", "log_w_mean", "n_particles"]


def _script(name):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


evaluator = _script("torch_eval_checkpoint")
writer = _script("torch_create_dataset")
variant = _script("torch_run_variant")
figure = _script("torch_make_explainaway_fig")


def _jax_apply():
    """``scripts/run_variant.py``'s ``_apply``."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from run_variant import _apply
    finally:
        sys.path.pop(0)
    return _apply


# --- apply_overrides ------------------------------------------------------

@pytest.mark.parametrize("preset, section, item", [
    ("canonical_fast", "data", "digit_size=(20,20)"),
    ("canonical_fast", "data", "cell_margin=0.08"),
    ("canonical_fast", "model", "encoder_conv=(16,32)"),
    ("canonical_fast", "model", "remat=False"),
    ("canonical", "model", "decoder_dtype='float32'"),
    ("canonical_fast", "train", "n_iters=3"),
    ("canonical_fast", "prior", "anneal_steps=10"),
])
def test_apply_overrides_matches_run_variant(preset, section, item):
    want = _jax_apply()(getattr(jcfg.get_config(preset), section),
                        [item, item])
    got = tcfg.apply_overrides(getattr(tcfg.get_config(preset), section),
                               [item, item])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != getattr(tcfg.get_config(preset), section)


@pytest.mark.parametrize("section", ["model", "train", "data", "prior"])
def test_apply_overrides_typo_exits_as_run_variant(section):
    with pytest.raises(SystemExit) as want:
        _jax_apply()(getattr(jcfg.get_config("canonical"), section),
                     ["n_iter=3"])
    with pytest.raises(SystemExit) as got:
        tcfg.apply_overrides(getattr(tcfg.get_config("canonical"), section),
                             ["n_iter=3"])
    assert str(got.value) == str(want.value)
    assert "has no field 'n_iter'" in str(got.value)
    assert tcfg.apply_overrides(tcfg.ModelConfig(), None) == \
        tcfg.ModelConfig()


# --- the evaluator against the JAX script's calls -------------------------

@pytest.fixture(scope="module")
def paired():
    """JAX config/model/state at step 3 and the port's state with the same
    parameters."""
    kw = dict(model=dict(TINY, explore_eps=0.05),
              prior=dict(anneal_start=1, anneal_steps=4))
    jc, tc = (mod.Config(model=mod.ModelConfig(**kw["model"]),
                         prior=mod.PriorAnnealConfig(**kw["prior"]),
                         train=mod.TrainConfig(batch_size=BATCH))
              for mod in (jcfg, tcfg))
    jm = JaxAIR(jc.model, use_baseline=True)
    jstate = jstate_mod.create_train_state(
        jc, jm, jnp.asarray(images(BATCH)), seed=0).replace(
            step=jnp.asarray(3, jnp.int32))
    state = create_train_state(tc, device="cpu")
    state.model.load_state_dict(params_from_flax(to_numpy_tree(
        jstate.params)))
    state.step = 3
    return jc, tc, jm, jstate, state


def test_evaluator_matches_jax_script(paired, capsys):
    """``count_confusion``, ``evaluate``, the 5-particle IWAE step, in the
    JAX script's order, with its keys ``fold_in(key, 9999)``,
    ``fold_in(key, 777)`` and ``fold_in(key, 32)``."""
    jc, tc, jm, jstate, state = paired
    key = jax.random.key(1234)
    data = []
    for i in range(3):
        nums = np.random.default_rng(80 + i).integers(0, 3, BATCH)
        data.append((images(BATCH, seed=80 + i), nums.astype(np.int32)))
    iw_imgs = images(BATCH, seed=90)

    def jax_batches():
        return ((jnp.asarray(x), jnp.asarray(n)) for x, n in data)

    with binarized_presence():
        jeval = jstep_mod.make_eval_step(jc, jm)
        conf = janalyze.count_confusion(jeval, jstate, jax_batches(),
                                        jax.random.fold_in(key, 9999))
        ev = jmetrics.evaluate(jeval, jstate, jax_batches(),
                               jax.random.fold_in(key, 777))
        jm_iw = JaxAIR(dataclasses.replace(jc.model, explore_eps=None),
                       use_baseline=True)
        iw = jiwae.make_iwae_eval_step(jc, jm_iw, n_particles=5)(
            jstate, jnp.asarray(iw_imgs), jax.random.fold_in(key, 32))

    # the port's calls get the JAX draws of the same keys, in call order
    keys = iter([jax.random.fold_in(jax.random.fold_in(key, w), i)
                 for w in (9999, 777) for i in range(len(data))])
    eval_step = make_eval_step(tc, state.model)

    def with_jax_noise(st, imgs, nums, generator):
        return eval_step(st, imgs, nums, noise=forward_noise(
            jc.model, next(keys), BATCH, binarize=True))

    iwae_step = make_iwae_eval_step(tc, state.model.with_config(
        dataclasses.replace(tc.model, explore_eps=None)), n_particles=5)
    iw_noise = [forward_noise(jc.model, k, BATCH, binarize=True)
                for k in jax.random.split(jax.random.fold_in(key, 32), 5)]
    out = evaluator.evaluate_checkpoint(
        state, [(torch.from_numpy(x), torch.from_numpy(n)) for x, n in data],
        with_jax_noise,
        lambda st, imgs, generator: iwae_step(st, imgs, noise=iw_noise),
        torch.from_numpy(iw_imgs), seed=1234)
    assert next(keys, None) is None

    got = out["confusion"]
    np.testing.assert_array_equal(got["confusion"], conf["confusion"])
    np.testing.assert_array_equal(got["per_class_accuracy"],
                                  conf["per_class_accuracy"])
    np.testing.assert_array_equal(got["mean_predicted"],
                                  conf["mean_predicted"])
    assert got["accuracy"] == conf["accuracy"]
    assert out["table"] == janalyze.format_confusion(conf)
    raw = out["raw"]
    assert sorted(raw["eval"]) == sorted(ev)
    for k, v in ev.items():
        if "accuracy" in k:
            assert raw["eval"][k] == v, k
        else:
            np.testing.assert_allclose(raw["eval"][k], v, err_msg=k, **TOL)
    assert sorted(raw["iwae"]) == sorted(iw) == IWAE_KEYS
    for k, v in iw.items():
        np.testing.assert_allclose(raw["iwae"][k], float(v), err_msg=k,
                                   **TOL)
    # what it prints: the table, then the two JSON lines
    assert sorted(out["eval"]) == EVAL_KEYS
    lines = capsys.readouterr().out.splitlines()
    assert lines[:-2] == out["table"].splitlines()
    assert json.loads(lines[-2]) == out["eval"]
    assert json.loads(lines[-1]) == out["iwae"]


# --- restores and the command line, on a 4-step CPU run --------------------

TINY_RUN = tcfg.Config(
    name="tiny_tools",
    model=tcfg.ModelConfig(**dict(TINY, explore_eps=0.05)),
    data=tcfg.DataConfig(canvas_size=(24, 24), digit_size=(8, 8)),
    train=tcfg.TrainConfig(batch_size=8, learning_rate=1e-3, n_iters=4,
                           log_every=1, save_every=2, fig_every=10**9,
                           eval_batches=1),
    prior=tcfg.PriorAnnealConfig(anneal_start=1, anneal_steps=4))


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tcfg.PRESETS, "tiny_tools", TINY_RUN)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 4-step CPU ``train()`` of ``TINY_RUN`` with checkpoints (every 2
    steps) and a best checkpoint (logged every step)."""
    workdir = tmp_path_factory.mktemp("tiny_run")
    state = train(TINY_RUN, workdir=str(workdir), use_tensorboard=False,
                  device="cpu")
    return workdir, state


def _saved(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("best", [False, True])
def test_evaluator_restores_saved_state(tiny_run, best):
    workdir, final = tiny_run
    got = evaluator.restore_state(TINY_RUN, str(workdir), best=best,
                                  device="cpu")
    if best:
        step = json.loads((workdir / "ckpt_best" / "best.json").read_text()
                          )["step"]
        blob = _saved(workdir / "ckpt_best" / str(step) / "state.pt")
    else:
        step = 4
        blob = _saved(workdir / "ckpt" / "4" / "state.pt")
        for (k, a), b in zip(got.model.state_dict().items(),
                             final.model.state_dict().values()):
            assert torch.equal(a, b), k
    assert got.step == blob["step"] == step
    assert got.base_seed == blob["base_seed"]
    for k, v in blob["model"].items():
        assert torch.equal(got.model.state_dict()[k], v), k
    for g, saved in blob["opt_state"].items():
        st = got.opt_state[g]
        assert st.count == saved["count"]
        for a, b in zip(st.nu + st.trace, saved["nu"] + saved["trace"]):
            assert torch.equal(a, b), g


@pytest.mark.parametrize("best", [False, True])
def test_evaluator_empty_workdir_exits(tmp_path, tiny_preset, best):
    sub = "ckpt_best" if best else "ckpt"
    argv = ["--config", "tiny_tools", "--workdir", str(tmp_path),
            "--device", "cpu"] + (["--best"] if best else [])
    with pytest.raises(SystemExit) as e:
        evaluator.main(argv)
    # the JAX script's message, and nothing made in the workdir
    assert str(e.value) == f"no checkpoint under {tmp_path}/{sub}"
    assert list(tmp_path.iterdir()) == []


def test_evaluator_main_prints_the_jax_keys(tiny_run, tiny_preset, capsys):
    workdir, _ = tiny_run
    out = evaluator.main(["--config", "tiny_tools", "--workdir",
                          str(workdir), "--batches", "2", "--batch-size",
                          "8", "--iwae", "--device", "cpu"])
    assert out["restored_step"] == 4
    assert out["confusion"]["confusion"].sum() == 2 * 8
    assert sorted(out["eval"]) == EVAL_KEYS
    assert sorted(out["iwae"]) == IWAE_KEYS
    assert all(math.isfinite(v) for v in {**out["eval"], **out["iwae"]}
               .values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 4"
    assert json.loads(lines[-2]) == out["eval"]
    assert json.loads(lines[-1]) == out["iwae"]


def test_run_variant_trains_the_overridden_config(tmp_path, tiny_preset):
    state = variant.main([
        "--config", "tiny_tools", "--workdir", str(tmp_path), "--iters", "2",
        "--model-set", "max_scale=0.45", "--train-set", "log_every=2",
        "--data-set", "cell_margin=0.08", "--prior-set", "anneal_steps=7",
        "--no-checkpoints", "--device", "cpu"])
    assert state.step == 2 and state.model.cfg.max_scale == 0.45
    rows = [json.loads(r) for r in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["split"]) for r in rows] == \
        [(2, "train"), (2, "eval"), (2, "train_eval")]
    assert not (tmp_path / "ckpt").exists()
    with pytest.raises(SystemExit, match="TrainConfig has no field 'n_iter'"):
        variant.main(["--config", "tiny_tools", "--workdir", str(tmp_path),
                      "--train-set", "n_iter=2", "--device", "cpu"])


# --- the explain-away selection -------------------------------------------

@pytest.mark.parametrize("max_scale, min_iou",
                         [(None, 0.02), (0.45, 0.02), (0.3, 0.2)])
def test_select_scenes_matches_jax_script(max_scale, min_iou):
    rng = np.random.default_rng(5)
    b = 512
    z_where = np.concatenate(
        [rng.uniform(0.1, 0.8, (b, 3, 2)), rng.uniform(-0.5, 0.5, (b, 3, 2))],
        axis=-1).astype(np.float32)
    pres = (rng.random((b, 3)) < 0.8).astype(np.float32)
    mode_steps = rng.integers(0, 4, b)

    # scripts/make_explainaway_fig.py, the selection
    zw = np.array(z_where)
    if max_scale is not None:
        zw[..., :2] = np.minimum(zw[..., :2], max_scale)
    iou = np.asarray(jax_iou(
        zw[:, 0, 2], zw[:, 0, 3], zw[:, 0, 0], zw[:, 0, 1],
        zw[:, 1, 2], zw[:, 1, 3], zw[:, 1, 0], zw[:, 1, 1]))
    both = (pres[:, 0] > 0) & (pres[:, 1] > 0)
    want = np.where(both & (mode_steps == 2) & (iou >= min_iou))[0]
    want = want[np.argsort(-iou[want])][:8]

    got, got_iou = figure.select_scenes(
        torch.from_numpy(z_where), torch.from_numpy(pres),
        torch.from_numpy(mode_steps), max_scale, min_iou)
    assert len(want) == 8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_iou, iou)


def test_explainaway_finds_and_renders(tiny_run, tmp_path, monkeypatch):
    workdir, _ = tiny_run
    monkeypatch.setitem(tcfg.PRESETS, "tiny_tools", dataclasses.replace(
        TINY_RUN, model=dataclasses.replace(TINY_RUN.model, max_scale=0.5)))
    args = figure.parse_args(["--config", "tiny_tools", "--workdir",
                              str(workdir), "--batch", "16", "--device",
                              "cpu"])
    scenes = figure.find_scenes(args)
    out = scenes["outputs"]
    sel, iou = figure.select_scenes(out.steps.z_where, out.steps.pres,
                                    out.mode_steps, 0.5, 0.02)
    assert scenes["restored_step"] == 4
    np.testing.assert_array_equal(scenes["sel"], sel)
    np.testing.assert_array_equal(scenes["iou"], iou)
    assert scenes["nums"].tolist() == [2] * 16
    # render any two scenes: matplotlib writes them, and without it the
    # render raises its ImportError
    two = dict(scenes, sel=np.array([3, 1]))
    assert figure.render(two, str(tmp_path / "fig.png")) == \
        str(tmp_path / "fig.png")
    assert (tmp_path / "fig.png").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        figure.render(two, str(tmp_path / "again.png"))


# --- the dataset writer ---------------------------------------------------

WRITE = ["--device", "cpu", "--n-train", "96", "--n-validation", "32",
         "--chunk", "64", "--canvas-size", "24", "--min-digits", "1"]
TAGS = ("mnist_train", "mnist_validation")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Seed 0 written with JAX blocked (a subprocess), seed 0 again and
    seed 1 in this process; ``{name: (outdir, stdout)}``."""
    out = {}
    a = tmp_path_factory.mktemp("seed0")
    proc = subprocess.run(
        [sys.executable, str(HELPER), "scripts/torch_create_dataset.py",
         "--outdir", str(a), *WRITE], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out["seed0"] = (a, proc.stdout)
    for name, seed in (("again", "0"), ("seed1", "1")):
        d = tmp_path_factory.mktemp(name)
        out[name] = (d, writer.main(["--outdir", str(d), "--seed", seed,
                                     *WRITE]))
    return out


def _blob(outdir, tag):
    with open(outdir / f"{tag}.pickle", "rb") as f:
        return pickle.load(f)


def test_dataset_writer_output(written):
    outdir, stdout = written["seed0"]
    assert stdout.splitlines()[-1] == "FINISHED; JAX modules loaded: []"
    for tag, n in zip(TAGS, (96, 32)):
        blob = _blob(outdir, tag)
        assert sorted(blob) == ["imgs", "nums"]
        assert blob["imgs"].dtype == np.float32 and \
            blob["imgs"].shape == (n, 24, 24)
        assert blob["nums"].dtype == np.int32 and blob["nums"].shape == (n,)
        assert blob["nums"].min() >= 1 and blob["nums"].max() <= 2
        assert np.isfinite(blob["imgs"]).all()
        assert blob["imgs"].min() >= 0.0 and blob["imgs"].max() <= 1.0
        hist = np.bincount(blob["nums"])
        assert (f"wrote {outdir / tag}.pickle: imgs {blob['imgs'].shape}, "
                f"count histogram {hist}") in stdout
    again = written["again"][1]
    assert again["mnist_validation"]["histogram"] == \
        np.bincount(_blob(outdir, TAGS[1])["nums"]).tolist()


def test_dataset_writer_is_seeded(written):
    for tag in TAGS:
        a, again, other = ((written[k][0] / f"{tag}.pickle").read_bytes()
                           for k in ("seed0", "again", "seed1"))
        assert a == again
        assert not np.array_equal(pickle.loads(a)["imgs"],
                                  pickle.loads(other)["imgs"])
    # the two splits draw from other seeds (and banks)
    s0 = written["seed0"][0]
    assert not np.array_equal(_blob(s0, TAGS[0])["imgs"][:32],
                              _blob(s0, TAGS[1])["imgs"])


@pytest.mark.parametrize("tag", TAGS)
def test_dataset_pickle_loads_as_jax_loads_it(written, tag):
    path = str(written["seed0"][0] / f"{tag}.pickle")
    want, got = jloader.load_data(path), load_data(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "streamed"])
def test_train_from_written_pickles(written, tmp_path, resident):
    outdir = written["seed0"][0]
    cfg = dataclasses.replace(TINY_RUN, train=dataclasses.replace(
        TINY_RUN.train, log_every=2, eval_batches=2))
    state = train(cfg, workdir=str(tmp_path), n_iters=2,
                  use_tensorboard=False, save_checkpoints=False,
                  data_path=str(outdir / "mnist_train.pickle"),
                  eval_data_path=str(outdir / "mnist_validation.pickle"),
                  resident_data=resident, device="cpu")
    assert state.step == 2
    rows = [json.loads(r) for r in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["split"]) for r in rows] == \
        [(2, "train"), (2, "eval"), (2, "train_eval")]
    assert all(math.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))
