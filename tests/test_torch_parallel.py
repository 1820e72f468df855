"""PyTorch port: data parallelism, the fast tests of ``tests/test_parallel.py``
ported, and the explicit shard-map step against the JAX package's.

Each case runs its ranks as a 2-process gloo group on the CPU, in
subprocesses with JAX blocked from import
(``tests/helpers/torch_parallel_helper.py``), meeting through a
``FileStore`` in ``tmp_path``; a case that outlives its timeout fails.
Tolerances are ``tests/test_parallel.py``'s: metrics rel 1e-5 (the mean
of two half-batch means against one full-batch mean), parameters rtol
2e-5 and atol 1e-6 after one update; the JAX comparison has
``tests/test_torch_train.py``'s f32 step tolerances.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.convert import params_from_flax
from torch_parity import binarized_presence, forward_noise, to_numpy_tree

HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers",
                      "torch_parallel_helper.py")
WORLD, TIMEOUT = 2, 120
MESH_TOL = dict(metric=1e-5, rtol=2e-5, atol=1e-6)


def tiny_config(**train_kw) -> tcfg.Config:
    """``tests/test_train.py``'s tiny config: batch 8, 14×14 canvases."""
    return tcfg.Config(
        model=tcfg.ModelConfig(
            img_size=(14, 14), glimpse_size=(6, 6), n_what=4, max_steps=2,
            rnn_hidden=16, encoder_hidden=(16,),
            glimpse_encoder_hidden=(16,), decoder_hidden=(16,),
            transform_hidden=(16,), steps_hidden=(8,),
            baseline_hidden=(16,)),
        data=tcfg.DataConfig(canvas_size=(14, 14), digit_size=(8, 8),
                             min_digits=0, max_digits=2),
        train=tcfg.TrainConfig(batch_size=8, learning_rate=1e-4,
                               **train_kw),
        prior=tcfg.PriorAnnealConfig(anneal_start=2, anneal_steps=10))


def run_ranks(tmp_path, case, config, **inputs):
    """Run ``case`` on ``WORLD`` gloo ranks; returns each rank's output."""
    inp = tmp_path / "inputs.pt"
    torch.save(dict(inputs, config=dataclasses.asdict(config)), inp)
    procs = [subprocess.Popen(
        [sys.executable, HELPER, "--case", case, "--rank", str(r),
         "--world", str(WORLD), "--store", str(tmp_path / "store"),
         "--inputs", str(inp), "--out", str(tmp_path / f"out{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{case}: the ranks did not finish in {TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case} rank {r}:\n{log[-3000:]}"
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(WORLD)]
    assert all(o["jax_modules_loaded"] == [] for o in outs)
    return outs


def assert_steps_close(a, b, tol):
    assert a["step"] == b["step"]
    for k in b["metrics"]:
        np.testing.assert_allclose(a["metrics"][k], b["metrics"][k],
                                   rtol=tol["metric"], atol=1e-6, err_msg=k)
    for k, v in b["params"].items():
        torch.testing.assert_close(a["params"][k], v, rtol=tol["rtol"],
                                   atol=tol["atol"], msg=k)


def assert_ranks_agree(outs, key):
    """Every rank applied the same update."""
    for o in outs[1:]:
        for k, v in outs[0][key]["params"].items():
            assert torch.equal(o[key]["params"][k], v), k


# -- the mesh and the batch split --------------------------------------------

@pytest.fixture(scope="module")
def basics(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("basics"), "mesh_basics",
                     tiny_config())


def test_mesh_spans_the_process_group(basics):
    """(``test_virtual_devices_present``) Two ranks, one mesh axis."""
    assert [o["size"] for o in basics] == [WORLD] * WORLD
    assert all(o["names"] == ["data"] for o in basics)


def test_make_mesh_and_shardings(basics):
    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    for r, o in enumerate(basics):
        assert torch.equal(o["rows"], x[8 * r:8 * (r + 1)])
        assert torch.equal(o["gathered"], x)
        assert o["batch_sharding"] == "(Shard(dim=0),)"
        assert o["replicate"] == "(Replicate(),)"


def test_shard_batch_tree(basics):
    assert all(o["tree"] == {"imgs": (4, 5, 5), "nums": (4,)}
               for o in basics)


# -- the train steps ---------------------------------------------------------

@pytest.mark.parametrize("train_kw", [
    {}, dict(advantage_norm=True),
    dict(objective="iwae", iwae_particles=3, use_baseline=False)],
    ids=["elbo", "advantage_norm", "iwae"])
def test_dp_train_step_matches_single_device(tmp_path, train_kw):
    """The mesh step (GSPMD's meaning: the global batch and noise, each
    rank its rows, gradients and metrics averaged) equals the
    single-process step; with ``advantage_norm`` its statistic is the
    global batch's."""
    outs = run_ranks(tmp_path, "mesh_step", tiny_config(**train_kw))
    for o in outs:
        assert_steps_close(o["mesh"], o["single"], MESH_TOL)
    assert_ranks_agree(outs, "mesh")


def test_scan_step_composes_with_mesh(tmp_path):
    """K steps through ``make_scan_train_step(..., mesh=)`` (eager by
    design) equal K sequential mesh steps, row for row."""
    k = 4
    outs = run_ranks(tmp_path, "scan_mesh", tiny_config(scan_steps=k), k=k)
    for o in outs:
        assert o["scan"]["step"] == o["seq"]["step"] == k
        assert_steps_close(o["scan"], o["seq"],
                           dict(metric=1e-5, rtol=1e-5, atol=1e-7))
        assert len(o["scan"]["metrics"]["elbo"]) == k


@pytest.mark.parametrize("train_kw", [
    {}, dict(objective="iwae", iwae_particles=3)], ids=["elbo", "iwae"])
def test_shardmap_matches_plain_step(tmp_path, train_kw):
    """The external-batch shard-map step (the whole batch on every rank,
    the plain step's generators) equals the plain step on that batch."""
    from attend_infer_repeat_torch.data import load_digit_bank, make_synth_fn

    cfg = tiny_config(**train_kw)
    bank, _ = load_digit_bank("auto", digit_size=(8, 8))
    imgs, nums = make_synth_fn(cfg.data, bank, device="cpu")(
        8, torch.Generator().manual_seed(7))
    outs = run_ranks(tmp_path, "shardmap_external", cfg,
                     batch=(imgs.clone(), nums.clone()))
    for o in outs:
        assert_steps_close(o["shardmap"], o["plain"], MESH_TOL)
    assert_ranks_agree(outs, "shardmap")


def test_shardmap_train_step(tmp_path):
    """Each rank on its own shard: deterministic across calls, advances,
    every rank applies the same update."""
    outs = run_ranks(tmp_path, "shardmap_per_rank", tiny_config())
    for o in outs:
        a, b = o["runs"]
        assert a["first"]["step"] == 1 and a["second"]["step"] == 2
        assert np.isfinite(a["first"]["metrics"]["elbo"])
        assert a["first"]["metrics"] == b["first"]["metrics"]
        assert max((a["second"]["params"][k] - v).abs().max().item()
                   for k, v in a["first"]["params"].items()) > 0
    for k, v in outs[0]["runs"][0]["second"]["params"].items():
        assert torch.equal(outs[1]["runs"][0]["second"]["params"][k], v)


def test_shardmap_matches_jax_shardmap(tmp_path):
    """The port's external-batch shard-map step on 2 gloo ranks against
    the JAX package's on a 2-device mesh of the virtual CPUs: same
    weights, batch and noise (the JAX draws, presence binarized)."""
    from attend_infer_repeat_tpu.models.air import AIRModel as JaxAIR
    from attend_infer_repeat_tpu.parallel import make_mesh, replicate
    from attend_infer_repeat_tpu.parallel.shard_map_step import (
        make_shardmap_train_step)
    from attend_infer_repeat_tpu.train import create_train_state
    from test_torch_train import CASES, TRAIN, batch, configs

    jc, tc = configs({})
    tol = CASES["f32_baseline"][2]
    jm = JaxAIR(jc.model, use_baseline=True)
    imgs, nums = batch(0)
    state = create_train_state(jc, jm, jnp.asarray(imgs), seed=0)
    init = params_from_flax(to_numpy_tree(state.params))
    mesh = make_mesh(2)
    step = make_shardmap_train_step(jc, jm, np.zeros((1, 8, 8), np.float32),
                                    mesh, external_batch=True)
    k_model = jax.random.split(jax.random.fold_in(state.base_key, 0))[1]
    with binarized_presence():
        ref_state, ref = step(jax.device_put(state, replicate(mesh)),
                              (jnp.asarray(imgs), jnp.asarray(nums)))
        noise = forward_noise(jc.model, k_model, imgs.shape[0],
                              binarize=True)
    outs = run_ranks(tmp_path, "shardmap_external", tc, params=init,
                     batch=(torch.from_numpy(imgs), torch.from_numpy(nums)),
                     noise=noise)
    want = params_from_flax(to_numpy_tree(ref_state.params))
    for o in outs:
        got = o["shardmap"]
        for k in ("elbo", "grad_norm", "count_accuracy", "baseline_mse"):
            np.testing.assert_allclose(got["metrics"][k], float(ref[k]),
                                       rtol=tol["metric"], atol=1e-6,
                                       err_msg=k)
        for n, v in want.items():
            lr = TRAIN["baseline_learning_rate"] if n.startswith(
                "baseline.") else TRAIN["learning_rate"]
            err = (got["params"][n] - v).abs().max().item()
            assert err <= tol["param"] * lr, (n, err)


# -- serving -----------------------------------------------------------------

@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("serving"), "serving",
                     tiny_config())


@pytest.mark.parametrize("tile", [None, 4], ids=["one_pass", "tiled"])
def test_serving_infer_sharded_matches_single_device(serving, tile):
    """Each rank infers its rows with the whole batch's noise; every rank
    gets the whole result, equal to the single-device call."""
    for o in serving:
        single, sharded = o[f"infer/{tile}/single"], o[f"infer/{tile}/mesh"]
        for k in ("elbo", "canvas", "presence", "num_steps_pmf"):
            assert sharded[k].shape == single[k].shape
            torch.testing.assert_close(sharded[k], single[k], rtol=1e-5,
                                       atol=1e-6, msg=k)


def test_serving_generate_sharded_matches_single_device(serving):
    for o in serving:
        assert o["generate/mesh"].shape == (16, 14, 14)
        torch.testing.assert_close(o["generate/mesh"], o["generate/single"],
                                   rtol=1e-5, atol=1e-6)
