"""PyTorch port: the analysis tools (``scripts/torch_*.py``) against the
JAX scripts' own code paths.

The overlap characterization on the JAX synthesizer's draws; the overlap
binning against ``scripts/analyze_overlap_errors.py``'s (copied below) and
its eval path against the JAX eval step on the same weights and noise;
``CountCNN`` on carried-over flax weights and its train step against the
JAX script's ``optax.adam`` step; the IWAE k-sweep against the JAX loop;
the parity check's comparison; the ablation and probe variants field for
field; each script's command line with JAX blocked, and short CPU runs of
each ``main``.  All on the CPU at tiny width.
"""

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.convert import params_from_flax
from attend_infer_repeat_torch.data import load_digit_bank, synthesize_batch
from attend_infer_repeat_torch.eval import make_iwae_eval_step
from attend_infer_repeat_torch.train import (
    CheckpointManager,
    create_train_state,
    make_eval_step,
    train,
)
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.data import synth as jsynth
from attend_infer_repeat_tpu.eval import iwae as jiwae
from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR
from attend_infer_repeat_tpu.train import state as jstate_mod
from attend_infer_repeat_tpu.train import step as jstep_mod
from torch_parity import (
    TINY,
    binarized_presence,
    forward_noise,
    synth_draws,
    to_numpy_tree,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HELPER = ROOT / "tests" / "helpers" / "torch_no_jax_helper.py"
BATCH = 8
# f32 end to end, the limit tests/test_torch_eval.py states for the same
# functions: the two forwards sum in other orders
TOL = dict(rtol=2e-5, atol=1e-5)


def _script(name):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


overlap = _script("torch_characterize_overlap")
errors = _script("torch_analyze_overlap_errors")
ceiling = _script("torch_supervised_ceiling")
ksweep = _script("torch_iwae_ksweep")
parity = _script("torch_parity_check")
ablate = _script("torch_ablate_canonical")
probe = _script("torch_probe_u28")
prescreen = _script("torch_cpu_prescreen_u28")


def _jax_script(name):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


# tiny uniform-placement scenes: 0-2 digits of 8 px scaled up to 1.6× on
# 24×24, heavy overlap allowed, so that every IoU bin fills
DATA = dict(canvas_size=(24, 24), digit_size=(8, 8), placement="uniform",
            scale_range=(1.0, 1.6), overlap_iou_max=0.5)
TINY_RUN = tcfg.Config(
    name="tiny_analysis",
    model=tcfg.ModelConfig(**dict(TINY, explore_eps=0.05)),
    data=tcfg.DataConfig(**DATA),
    train=tcfg.TrainConfig(batch_size=BATCH, learning_rate=1e-3, n_iters=4,
                           log_every=2, save_every=2, fig_every=10**9,
                           eval_batches=1),
    prior=tcfg.PriorAnnealConfig(anneal_start=1, anneal_steps=4))


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tcfg.PRESETS, "tiny_analysis", TINY_RUN)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 4-step CPU ``train()`` of ``TINY_RUN`` with checkpoints."""
    workdir = tmp_path_factory.mktemp("tiny_run")
    train(TINY_RUN, workdir=str(workdir), use_tensorboard=False,
          device="cpu")
    return workdir


# --- return_meta and the overlap characterization ---------------------------

@pytest.mark.parametrize("name", ["canonical_fast", "canonical_uniform",
                                  "canonical_uniform28"])
def test_characterize_matches_jax_script(name):
    """The statistics of 64 canvases synthesized from the JAX script's keys
    (``fold_in(key(0), i)`` per chunk) equal its dict, key for key."""
    want = _jax_script("characterize_overlap").characterize(name, 64)
    data = jcfg.get_config(name).data
    bank, _ = load_digit_bank(data.source, data.digit_size)
    key = jax.random.key(0)
    got = overlap.characterize(
        name, 64, device="cpu", draws=lambda i, b: synth_draws(
            jax.random.fold_in(key, i), data, b, len(bank)))
    assert got == want
    assert got["n_multi_scenes"] > 0


def test_characterize_main_writes_the_table(tmp_path, tiny_preset, capsys):
    out = tmp_path / "rows.json"
    rows = overlap.main(["--configs", "tiny_analysis", "--n", "40",
                         "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == rows
    assert rows[0]["n_scenes"] == 40 and sum(rows[0]["iou_hist_pct"]) > 99
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "| " + " | ".join(overlap.TABLE_COLS) + " |"
    assert lines[-1] == f"saved {out}"


# --- the overlap binning --------------------------------------------------

def jax_script_bins(max_iou, correct, true_n, pred_n):
    """``scripts/analyze_overlap_errors.py:130-168`` (the rows, the table,
    the ceilings), as written there."""
    IOU_EDGES = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 1.0000001]
    n = len(correct)
    n_err = int((~correct).sum())
    rows = []
    sel = max_iou < 0
    rows.append(("<2 digits", sel))
    for lo, hi in zip(IOU_EDGES[:-1], IOU_EDGES[1:]):
        rows.append((f"IoU [{lo:.1f},{min(hi, 1.0):.1f})",
                     (max_iou >= lo) & (max_iou < hi)))
    table = []
    for label, sel in rows:
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        acc = float(correct[sel].mean())
        err_share = float((~correct[sel]).sum()) / max(n_err, 1)
        errs = sel & ~correct
        mode = ""
        if errs.any():
            kinds, counts = np.unique(
                [f"{t}->{p}" for t, p in zip(true_n[errs], pred_n[errs])],
                return_counts=True)
            mode = str(kinds[np.argmax(counts)])
        table.append({"bin": label, "n_scenes": cnt,
                      "pct_scenes": round(100.0 * cnt / n, 2),
                      "accuracy": round(acc, 4),
                      "pct_of_all_errors": round(100.0 * err_share, 2),
                      "dominant_error": mode})
    overall = float(correct.mean())
    ceilings = {}
    for thr in (0.3, 0.4, 0.5):
        hard = max_iou >= thr
        ceilings[f"ceiling_if_only_iou>={thr}_errors"] = round(
            1.0 - float((hard & ~correct).sum()) / n, 4)
    return table, overall, ceilings


@pytest.mark.parametrize("case", ["errors", "perfect", "sparse"])
def test_overlap_bins_match_jax_script(case):
    rng = np.random.default_rng(3)
    n = 2000
    max_iou = np.where(rng.random(n) < 0.3, -1.0, rng.random(n) ** 2)
    true_n = rng.integers(0, 3, n)
    flip = rng.random(n) < (0.2 if case == "errors" else 0.0)
    if case == "sparse":              # some bins empty, few errors
        max_iou = np.where(max_iou > 0.25, 0.7, max_iou)
        flip = rng.random(n) < 0.01
    pred_n = np.where(flip, (true_n + 1) % 3, true_n)
    table, overall, ceilings = jax_script_bins(max_iou, true_n == pred_n,
                                               true_n, pred_n)
    got = errors.overlap_bins(max_iou, true_n, pred_n)
    assert got["table"] == table
    assert got["accuracy"] == overall and got["ceilings"] == ceilings


@pytest.fixture(scope="module")
def paired():
    """JAX config/model/state at step 3 and the port's state with the same
    parameters, saved and restored through the port's checkpoint."""
    kw = dict(model=dict(TINY, explore_eps=0.05),
              prior=dict(anneal_start=1, anneal_steps=4), data=DATA)
    jc, tc = (mod.Config(model=mod.ModelConfig(**kw["model"]),
                         prior=mod.PriorAnnealConfig(**kw["prior"]),
                         data=mod.DataConfig(**kw["data"]),
                         train=mod.TrainConfig(batch_size=BATCH))
              for mod in (jcfg, tcfg))
    jm = JaxAIR(jc.model, use_baseline=True)
    rng = np.random.default_rng(0)
    jstate = jstate_mod.create_train_state(
        jc, jm, jnp.asarray(rng.random((BATCH, 24, 24)), jnp.float32),
        seed=0).replace(step=jnp.asarray(3, jnp.int32))
    state = create_train_state(tc, device="cpu")
    state.model.load_state_dict(params_from_flax(to_numpy_tree(
        jstate.params)))
    state.step = 3
    return jc, tc, jm, jstate, state


def test_overlap_errors_eval_path_matches_jax_script(paired, tmp_path):
    """The JAX script's loop (``:96-122``: held-out batch ``fold_in(key,
    i)``, noise ``fold_in(key, 10000 + i)``) and the port's
    ``count_by_overlap`` on a restored checkpoint of the same weights,
    with the JAX noise: the same IoUs, counts and bins."""
    jc, tc, jm, jstate, state = paired
    CheckpointManager(str(tmp_path / "ckpt")).save(state, force=True)
    restored = errors.restore_state(tc, str(tmp_path), device="cpu")
    assert restored.step == 3
    bank, _ = load_digit_bank("auto", (8, 8), split="eval")
    key = jax.random.key(1234)

    # the scenes outside the binarized presence, which patches every
    # uniform draw
    jscenes = [jsynth.synthesize_batch(
        jax.random.fold_in(key, i), jnp.asarray(bank.numpy()), jc.data,
        BATCH, return_meta=True) for i in range(3)]
    max_ious, trues, preds = [], [], []
    with binarized_presence():
        jeval = jstep_mod.make_eval_step(jc, jm)
        for i, (imgs, nums, meta) in enumerate(jscenes):
            _, outputs = jeval(jstate, imgs, nums,
                               jax.random.fold_in(key, 10_000 + i))
            sx, sy, tx, ty = (meta[k] for k in ("sx", "sy", "tx", "ty"))
            present = np.asarray(meta["present"]) > 0
            best = np.full(sx.shape[0], -1.0)
            for a in range(sx.shape[1]):
                for b in range(a + 1, sx.shape[1]):
                    both = present[:, a] & present[:, b]
                    iou = np.asarray(jsynth._pairwise_iou(
                        tx[:, a], ty[:, a], sx[:, a], sy[:, a],
                        tx[:, b], ty[:, b], sx[:, b], sy[:, b]))
                    best = np.where(both, np.maximum(best, iou), best)
            max_ious.append(best)
            trues.append(np.asarray(nums).astype(int))
            preds.append(np.asarray(outputs.mode_steps).astype(int))
    want = [np.concatenate(a) for a in (max_ious, trues, preds)]

    scenes = [synthesize_batch(bank, tc.data, BATCH, draws=synth_draws(
        jax.random.fold_in(key, i), jc.data, BATCH, len(bank)),
        return_meta=True) for i in range(3)]
    keys = iter(jax.random.fold_in(key, 10_000 + i) for i in range(3))
    eval_step = make_eval_step(tc, restored.model)

    def with_jax_noise(st, imgs, nums, generator):
        return eval_step(st, imgs, nums, noise=forward_noise(
            jc.model, next(keys), BATCH, binarize=True))

    got = errors.count_by_overlap(restored, with_jax_noise, scenes, 1234)
    assert next(keys, None) is None
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[0] >= 0).any() and (got[0] < 0).any()
    assert errors.overlap_bins(*got) == errors.overlap_bins(*want)


def test_overlap_errors_main(tiny_run, tiny_preset, tmp_path, capsys):
    out = tmp_path / "errors.json"
    got = errors.main(["--config", "tiny_analysis", "--workdir",
                       str(tiny_run), "--batches", "2", "--batch-size", "8",
                       "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["step"] == 4 and got["n_scenes"] == 16
    assert sum(r["n_scenes"] for r in got["bins"]) == 16
    assert sorted(k for k in got if k.startswith("ceiling")) == [
        f"ceiling_if_only_iou>={t}_errors" for t in (0.3, 0.4, 0.5)]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 4" and lines[-1] == f"saved {out}"
    with pytest.raises(SystemExit, match="no checkpoint under"):
        errors.main(["--config", "tiny_analysis", "--workdir",
                     str(tmp_path), "--device", "cpu"])


# --- the supervised ceiling -----------------------------------------------

def flax_count_cnn(n_classes):
    """``scripts/supervised_ceiling.py:68-81``, as written there."""

    class CountCNN(fnn.Module):
        """3-block convnet -> GAP -> count logits (supervised oracle)."""

        @fnn.compact
        def __call__(self, x):
            x = x[..., None]
            for feat in (32, 64, 128):
                x = fnn.Conv(feat, (3, 3))(x)
                x = fnn.relu(x)
                x = fnn.max_pool(x, (2, 2), strides=(2, 2))
            x = x.mean(axis=(1, 2))
            x = fnn.relu(fnn.Dense(128)(x))
            return fnn.Dense(n_classes)(x)

    return CountCNN()


@pytest.mark.parametrize("size", [(50, 50), (24, 24)])
def test_count_cnn_matches_flax(size):
    rng = np.random.default_rng(1)
    imgs = rng.random((4,) + size).astype(np.float32)
    jm = flax_count_cnn(3)
    params = jm.init(jax.random.key(0), jnp.asarray(imgs))
    model = ceiling.CountCNN(3, device="cpu")
    model.load_state_dict(params_from_flax(to_numpy_tree(params)))
    want = np.asarray(jm.apply(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's own init draws flax's distribution: same shapes, zero
    # biases, weights with variance 1/fan_in
    fresh = ceiling.CountCNN(3, device="cpu", seed=0)
    assert {k: v.shape for k, v in fresh.state_dict().items()} == \
        {k: v.shape for k, v in model.state_dict().items()}
    assert all(float(b.abs().max()) == 0 for k, b in
               fresh.state_dict().items() if k.endswith("bias"))


def test_ceiling_train_steps_match_optax():
    """Three steps of the JAX script's ``train_step`` (``:95-110``:
    synthesis from ``fold_in(key(seed + 1), s)``, softmax cross-entropy,
    ``optax.adam``) and of the port's, from the same weights and draws."""
    jdata = jcfg.DataConfig(**DATA)
    bank, _ = load_digit_bank("auto", (8, 8))
    jbank = jnp.asarray(bank.numpy())
    jm = flax_count_cnn(3)
    params = jm.init(jax.random.key(0), jnp.zeros((2, 24, 24)))
    tx = optax.adam(3e-4)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, key):
        imgs, nums = jsynth.synthesize_batch(key, jbank, jdata, BATCH)

        def loss_fn(p):
            logits = jm.apply(p, imgs)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, nums).mean()
            acc = (logits.argmax(-1) == nums).mean()
            return loss, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    model = ceiling.CountCNN(3, device="cpu")
    model.load_state_dict(params_from_flax(to_numpy_tree(params)))
    opt = ceiling.make_optimizer(model, 3e-4)
    step = ceiling.make_train_step(model, opt, tcfg.DataConfig(**DATA), bank,
                                   BATCH)
    key = jax.random.key(1)
    for s in range(3):
        k = jax.random.fold_in(key, s)
        params, opt_state, loss, acc = train_step(params, opt_state, k)
        got_loss, got_acc = step(draws=synth_draws(k, jdata, BATCH,
                                                   len(bank)))
        np.testing.assert_allclose(float(got_loss), float(loss), **TOL)
        assert float(got_acc) == float(acc)
    want = params_from_flax(to_numpy_tree(params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_ceiling_main(tiny_preset, tmp_path, capsys):
    out = tmp_path / "ceiling.json"
    got = ceiling.main(["--config", "tiny_analysis", "--steps", "2",
                        "--batch-size", "8", "--eval-batches", "2",
                        "--eval-batch-size", "8", "--device", "cpu",
                        "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["n_scenes"] == 16 and got["train_steps"] == 2
    assert sum(r["n_scenes"] for r in got["bins"]) == 16
    assert 0.0 <= got["supervised_accuracy"] <= 1.0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[0] loss=") and lines[1].startswith("[1] ")


# --- the IWAE k-sweep -------------------------------------------------------

@pytest.mark.parametrize("bounds", [[-10.0, -9.0, -8.5], [-10.0, -10.4],
                                    [-10.0, -10.6, -9.0], [-3.0]])
def test_monotone_follows_jax_logic(bounds):
    rows = [{"k": k, "iwae_bound": b, "n_images": 8}
            for k, b in zip([1, 5, 25], bounds)]
    mono = all(b2 >= b1 - 0.5 for b1, b2 in zip(bounds, bounds[1:]))
    assert ksweep.monotone(rows) == {"monotone_in_k": mono,
                                     "ks": [1, 5, 25][:len(bounds)],
                                     "bounds": bounds}


def test_ksweep_matches_jax_loop(paired, capsys):
    """The JAX script's loop (``:60-75``: particle keys ``fold_in(key,
    131·k + i)``) and the port's ``sweep`` on the same weights and images,
    with the JAX particles' noise."""
    jc, tc, jm, jstate, state = paired
    rng = np.random.default_rng(4)
    imgs = [(rng.random((BATCH, 24, 24)) *
             (rng.random((BATCH, 24, 24)) > 0.6)).astype(np.float32)
            for _ in range(2)]
    ks = [1, 3]
    key = jax.random.key(4321)
    jm_iw = JaxAIR(dataclasses.replace(jc.model, explore_eps=None),
                   use_baseline=True)
    want = {}
    with binarized_presence():
        for k in ks:
            step = jiwae.make_iwae_eval_step(jc, jm_iw, n_particles=k)
            want[k] = [float(step(jstate, jnp.asarray(im),
                                  jax.random.fold_in(key, k * 131 + i))
                             ["iwae_bound"]) for i, im in enumerate(imgs)]

    iwae_model = state.model.with_config(
        dataclasses.replace(tc.model, explore_eps=None))

    def make_step(k):
        port = make_iwae_eval_step(tc, iwae_model, n_particles=k)
        keys = iter(jax.random.fold_in(key, k * 131 + i)
                    for i in range(len(imgs)))

        def step(st, im, generator):
            noise = [forward_noise(jc.model, kk, BATCH, binarize=True)
                     for kk in jax.random.split(next(keys), k)]
            return port(st, im, noise=noise)
        return step

    rows = ksweep.sweep(state, make_step, [torch.from_numpy(i) for i in imgs],
                        ks, 4321)
    assert [r["k"] for r in rows] == ks
    for r in rows:
        np.testing.assert_allclose(r["iwae_bound"], np.mean(want[r["k"]]),
                                   rtol=0, atol=1e-3)
        assert r["n_images"] == 2 * BATCH
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in lines] == rows


def test_ksweep_main(tiny_run, tiny_preset, capsys):
    got = ksweep.main(["--config", "tiny_analysis", "--workdir",
                       str(tiny_run), "--ks", "1", "2", "--batches", "2",
                       "--batch-size", "4", "--device", "cpu"])
    assert [r["k"] for r in got["rows"]] == [1, 2]
    assert all(math.isfinite(r["iwae_bound"]) for r in got["rows"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored step 4"
    assert json.loads(lines[-1]) == got["monotone"] == ksweep.monotone(
        got["rows"])


# --- the parity check -------------------------------------------------------

def test_parity_compare_passes_equal_and_fails_perturbed(capsys):
    cfg = dataclasses.replace(TINY_RUN, model=dataclasses.replace(
        TINY_RUN.model, explore_eps=0.05))
    outs = parity.parity(cfg, 6, device="cpu")
    assert sorted(outs["cpu"]) == sorted(
        ["canvas", "elbo", "kl_steps", "kl_what", "kl_where", "pmf", "pres",
         "pres_prob"])
    res = parity.compare(outs["cpu"], outs["device"], 2e-2, 2e-2)
    assert res["ok"] and res["pres_agreement"] == 1.0
    assert res["n_compared"] == 6
    assert max(res["abs_err"].values()) == 0.0
    bad = dict(outs["device"], canvas=outs["device"]["canvas"] + 0.1)
    res = parity.compare(outs["cpu"], bad, 2e-2, 2e-2)
    assert not res["ok"] and not res["good"]["canvas"]
    assert res["good"]["elbo"]
    np.testing.assert_allclose(res["abs_err"]["canvas"], 0.1, rtol=1e-5)
    # a flipped presence sample: that example is left out of the rest
    flipped = dict(outs["device"], pres=outs["device"]["pres"].copy())
    flipped["pres"][2, 0] = 1.0 - flipped["pres"][2, 0]
    flipped["elbo"] = flipped["elbo"].copy()
    flipped["elbo"][2] += 100.0
    res = parity.compare(outs["cpu"], flipped, 2e-2, 2e-2)
    assert res["ok"] and res["n_compared"] == 5
    assert "boundary draws differ" in capsys.readouterr().out


# --- the ablation and probe variants ----------------------------------------

@pytest.mark.parametrize("variant", ablate.VARIANTS)
def test_ablation_variant_matches_jax(variant):
    want = _jax_script("ablate_canonical").make_variant(variant)
    assert dataclasses.asdict(ablate.make_variant(variant)) == \
        dataclasses.asdict(want)


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_probe_variant_matches_jax(variant):
    want = _jax_script("probe_u28").make_variant(variant)
    assert dataclasses.asdict(probe.make_variant(variant)) == \
        dataclasses.asdict(want)


def test_unknown_variants_exit_as_jax():
    for port, jax_name in ((ablate, "ablate_canonical"),
                           (probe, "probe_u28")):
        with pytest.raises(SystemExit) as want:
            _jax_script(jax_name).make_variant("nope")
        with pytest.raises(SystemExit) as got:
            port.make_variant("nope")
        assert str(got.value) == str(want.value)


def test_prescreen_config_matches_jax_script():
    """``scripts/cpu_prescreen_u28.py:53-62``: the probe variant renamed,
    with the seed and the CPU cadence."""
    cfg = _jax_script("probe_u28").make_variant("slimdec")
    want = dataclasses.replace(
        cfg, name="u28_cpu_slimdec",
        train=dataclasses.replace(cfg.train, seed=3, log_every=1_000,
                                  fig_every=8_001, save_every=2_000))
    assert dataclasses.asdict(prescreen.prescreen_config("slimdec", 8_000,
                                                         3)) == \
        dataclasses.asdict(want)


@pytest.mark.parametrize("tool", ["ablate", "probe", "prescreen"])
def test_variant_runners_train(tool, tmp_path, monkeypatch):
    """Each runner's ``main`` trains its variant for 2 steps into its
    workdir, on tiny presets in place of ``canonical`` and
    ``canonical_uniform28``."""
    tiny = dataclasses.replace(TINY_RUN, train=dataclasses.replace(
        TINY_RUN.train, log_every=2, eval_batches=1))
    monkeypatch.setitem(tcfg.PRESETS, "canonical", tiny)
    monkeypatch.setitem(tcfg.PRESETS, "canonical_uniform28", tiny)
    argv = {"ablate": ["--variant", "ref+all"],
            "probe": ["--variant", "tight", "--seed", "1"],
            "prescreen": ["--variant", "what20"]}[tool]
    argv += ["--iters", "2", "--workdir", str(tmp_path)]
    if tool != "prescreen":
        argv += ["--device", "cpu"]
    mod = {"ablate": ablate, "probe": probe, "prescreen": prescreen}[tool]
    state = mod.main(argv)
    assert state.step == 2 and state.model.device.type == "cpu"
    assert (tmp_path / "ckpt" / "2").is_dir()
    rows = [json.loads(r) for r in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["split"]) for r in rows][:2] == \
        [(2, "train"), (2, "eval")]


# --- the command lines, with JAX blocked ------------------------------------

SCRIPTS = ["torch_characterize_overlap", "torch_analyze_overlap_errors",
           "torch_supervised_ceiling", "torch_iwae_ksweep",
           "torch_parity_check", "torch_ablate_canonical", "torch_probe_u28",
           "torch_cpu_prescreen_u28"]


def _no_jax(*argv):
    return subprocess.run([sys.executable, str(HELPER), *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


# every script's --help in one process with JAX blocked (the helper's
# block), each as __main__; prints {script: [exit code, output]} and the
# blocked modules that were loaded
HELP_ALL = """
import contextlib, io, json, runpy, sys
sys.path.insert(0, "tests/helpers")
import torch_no_jax_helper as helper
got = {}
for name in sys.argv[1:]:
    sys.argv = [name, "--help"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(f"scripts/{name}.py", run_name="__main__")
    except SystemExit as e:
        got[name] = [e.code, out.getvalue()]
print(json.dumps(got))
print([m for m in sys.modules if m.split(".")[0] in helper.BLOCKED
       and sys.modules[m] is not None])
"""


@pytest.fixture(scope="module")
def helps():
    proc = subprocess.run([sys.executable, "-c", HELP_ALL, *SCRIPTS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got, loaded = proc.stdout.splitlines()[-2:]
    assert loaded == "[]"
    return json.loads(got)


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_run_without_jax(name, helps):
    code, text = helps[name]
    assert code in (0, None) and text.startswith("usage:")
    device = "--device {cuda,cpu}" in text.replace("\n", " ")
    # every tool takes --device, default cuda; the parity check compares
    # the CPU with the card, and the pre-screen is the CPU by name
    assert device == (name not in ("torch_parity_check",
                                   "torch_cpu_prescreen_u28"))


def test_cuda_default_raises_without_a_card(tiny_run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = _no_jax("scripts/torch_iwae_ksweep.py", "--workdir",
                   str(tiny_run))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    proc = _no_jax("scripts/torch_parity_check.py")
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
