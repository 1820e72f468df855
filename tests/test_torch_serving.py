"""PyTorch port: serving functions, tiled and untiled, against the JAX
package's; grid-placement synthesis with the JAX draws regenerated from its
key; the committed digit bank against scikit-learn's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.data import load_digit_bank, synthesize_batch
from attend_infer_repeat_torch.data.digits import BANK_PATH
from attend_infer_repeat_torch.serving import make_generate_fn, make_infer_fn
from attend_infer_repeat_torch.utils import graphs
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu import serving as jserving
from attend_infer_repeat_tpu.data import digits as jdigits
from attend_infer_repeat_tpu.data import synth as jsynth
from torch_parity import (
    assert_bit_equal,
    eager_mode,
    forward_noise,
    generate_noise,
    images,
    paired_models,
    synth_draws,
    uncaptured,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def configs(model_jax, model_torch):
    """The serving preset around the tiny model, in both packages."""
    return (dataclasses.replace(jcfg.get_config("serving"), model=model_jax),
            dataclasses.replace(tcfg.get_config("serving"),
                                model=model_torch))


def compare(out_t, out_j):
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape, k
        if k in ("presence", "predicted_steps", "mode_steps"):
            assert np.array_equal(a, b), k
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)


@pytest.mark.parametrize("tile", [None, 4])
def test_infer_matches_jax(tile):
    jm, params, tm = paired_models()
    jc, tc = configs(jm.cfg, tm.cfg)
    x = images(8, seed=5)
    key = jax.random.key(5)
    out_j = jserving.make_infer_fn(jc, jm, tile=tile)(params, jnp.asarray(x),
                                                      key)
    keys = [key] if tile is None else list(jax.random.split(key, 8 // tile))
    chunks = [forward_noise(jm.cfg, k, 8 // len(keys)) for k in keys]
    noise = tuple(torch.cat([c[i] for c in chunks], 1) for i in range(3))
    out_t = make_infer_fn(tc, tm, tile=tile)(torch.from_numpy(x), noise=noise)
    compare(out_t, out_j)


def test_tiled_infer_with_generators():
    _, _, tm = paired_models()
    cfg = dataclasses.replace(tcfg.get_config("serving"), model=tm.cfg)
    x = torch.from_numpy(images(8, seed=6))
    infer = make_infer_fn(cfg, tm, tile=4)
    a = infer(x, torch.Generator().manual_seed(1))
    b = infer(x, torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["z_where"].shape == (8, 3, 4) and a["canvas"].shape == (8, 24, 24)
    with pytest.raises(ValueError, match="divisible"):
        make_infer_fn(cfg, tm, tile=3)(x)


def test_generate_matches_jax_with_default_prior():
    jm, params, tm = paired_models()
    jc, tc = configs(jm.cfg, tm.cfg)
    key = jax.random.key(9)
    ref = jserving.make_generate_fn(jc, jm)(params, key, 6)
    noise = generate_noise(jm.cfg, key, 6, 1.0)      # default success_prob
    out = make_generate_fn(tc, tm)(6, noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    sampled = make_generate_fn(tc, tm, success_prob=0.5)(
        5, torch.Generator().manual_seed(0))
    assert sampled.shape == (5, 24, 24)


@pytest.mark.parametrize("cfg", [
    jcfg.DataConfig(),
    jcfg.DataConfig(max_digits=5, scale_range=(0.7, 1.0), digit_size=(12, 12),
                    canvas_size=(40, 40))], ids=["serving", "crowded-ish"])
def test_grid_synthesis_matches_jax(cfg):
    bank, _ = load_digit_bank("auto", cfg.digit_size)
    key = jax.random.key(2)
    imgs_j, nums_j = jsynth.synthesize_batch(key, jnp.asarray(bank.numpy()),
                                             cfg, 16)
    tcfg_data = tcfg.DataConfig(**dataclasses.asdict(cfg))
    imgs_t, nums_t = synthesize_batch(
        bank, tcfg_data, 16, draws=synth_draws(key, cfg, 16, len(bank)))
    assert np.array_equal(nums_t.numpy(), np.asarray(nums_j))
    np.testing.assert_allclose(imgs_t.numpy(), np.asarray(imgs_j),
                               rtol=1e-5, atol=1e-5)


def test_uniform_placement_synthesizes():
    """Uniform placement synthesizes (its parity with the JAX package is
    in ``test_torch_data.py``): in-range canvases and true counts."""
    bank, _ = load_digit_bank("auto", (16, 16))
    cfg = tcfg.DataConfig(placement="uniform", min_digits=1)
    imgs, nums = synthesize_batch(bank, cfg, 8,
                                  torch.Generator().manual_seed(0))
    assert imgs.shape == (8, 50, 50) and nums.shape == (8,)
    assert 0.0 <= float(imgs.min()) and float(imgs.max()) <= 1.0
    assert bool(((nums >= 1) & (nums <= 2)).all())
    assert bool((imgs.sum((1, 2)) > 0).all())


def test_committed_bank_equals_sklearn():
    pytest.importorskip("sklearn")
    from sklearn.datasets import load_digits

    raw = load_digits()
    blob = np.load(BANK_PATH)
    assert np.array_equal(blob["images"], raw.images.astype(np.uint8))
    assert np.array_equal(blob["images"].astype(np.float64), raw.images)
    assert np.array_equal(blob["labels"], raw.target)
    for split in ("train", "eval"):
        ours, lab = load_digit_bank("auto", (16, 16), split)
        ref, ref_lab = jdigits.load_digit_bank("auto", (16, 16), split)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
        assert np.array_equal(lab.numpy(), ref_lab)


# -- serving as graphs, without the capture ---------------------------------

def graphed_against_eager(fn, args, seed):
    """``fn(*args, generator)`` on its graphed path and eagerly from one
    generator state: the results bit-equal, the generators left in one
    state; a second graphed call leaves the first one's results alone.
    Returns the graphed results."""
    a, b = (torch.Generator().manual_seed(seed) for _ in range(2))
    got = fn(*args, a)
    with eager_mode():
        want = fn(*args, b)
    assert_bit_equal(got, want)
    assert torch.equal(a.get_state(), b.get_state())
    kept = graphs.copy(got)
    fn(*args, torch.Generator().manual_seed(seed + 1))
    assert_bit_equal(got, kept, "a later call changed an earlier result")
    return got


@pytest.mark.parametrize("tile", [None, 4])
def test_graphed_infer_equals_eager(uncaptured, tile):
    """``make_infer_fn``'s graphed path (its capture stubbed out), plain and
    tiled, from the caller's generator and with injected noise: bit-equal
    to the eager call; one graph of the batch's (or the tile's) shape."""
    _, _, tm = paired_models()
    cfg = dataclasses.replace(tcfg.get_config("serving"), model=tm.cfg)
    x = torch.from_numpy(images(8, seed=7))
    infer = make_infer_fn(cfg, tm, tile=tile)
    graphed_against_eager(infer, (x,), 3)
    noise = tm.sample_noise(8, torch.Generator().manual_seed(4))
    got = infer(x, noise=noise)
    with eager_mode():
        assert_bit_equal(got, infer(x, noise=noise))
    assert len(infer.graphs) == 1
    (entry,) = infer.graphs.values()
    assert entry.static[0].shape[0] == (8 if tile is None else tile)


def test_graphed_generate_equals_eager(uncaptured):
    _, _, tm = paired_models()
    cfg = dataclasses.replace(tcfg.get_config("serving"), model=tm.cfg)
    generate = make_generate_fn(cfg, tm, success_prob=0.5)
    graphed_against_eager(generate, (6,), 5)
    noise = tm.generate_noise(6, 0.5, torch.Generator().manual_seed(6))
    got = generate(6, noise=noise)
    with eager_mode():
        assert_bit_equal(got, generate(6, noise=noise))
    assert len(generate.graphs) == 1


def test_graphed_synthesis_equals_eager(uncaptured):
    from attend_infer_repeat_torch.data import make_synth_fn

    bank, _ = load_digit_bank("auto", (16, 16))
    for placement in ("grid", "uniform"):
        cfg = tcfg.DataConfig(placement=placement)
        synth = make_synth_fn(cfg, bank, device="cpu")
        graphed_against_eager(synth, (6,), 8)
        assert len(synth.graphs) == 1


def test_graphed_infer_refuses_replaced_parameters(uncaptured):
    _, _, tm = paired_models()
    cfg = dataclasses.replace(tcfg.get_config("serving"), model=tm.cfg)
    infer = make_infer_fn(cfg, tm)
    x = torch.from_numpy(images(4, seed=9))
    infer(x, torch.Generator().manual_seed(0))
    tm.decoder.mlp.dense[0].weight = torch.nn.Parameter(
        tm.decoder.mlp.dense[0].weight.detach().clone())
    with pytest.raises(ValueError, match="captured"):
        infer(x, torch.Generator().manual_seed(0))
