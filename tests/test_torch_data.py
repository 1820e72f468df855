"""PyTorch port: the data layer against the JAX package.

Uniform placement from the JAX synthesizer's own draws, the ``mnist:``
file bank (resize included), and the pickle loaders.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attend_infer_repeat_torch import configs as tcfg
from attend_infer_repeat_torch.data import (
    InMemoryDataset,
    batch_iterator,
    load_data,
    load_digit_bank,
    make_synth_fn,
    synthesize_batch,
    tensors_from_data,
)
from attend_infer_repeat_torch.data.loader import auto_split
from attend_infer_repeat_torch.data.synth import sample_draws
from attend_infer_repeat_torch.train.step import step_generators
from attend_infer_repeat_tpu import configs as jcfg
from attend_infer_repeat_tpu.data import digits as jdigits
from attend_infer_repeat_tpu.data import loader as jloader
from attend_infer_repeat_tpu.data import synth as jsynth

torch.set_num_threads(1)


def uniform_draws(key, cfg, batch, n_bank):
    """The JAX uniform-placement synthesizer's draws, from its key."""
    t_slots = max(cfg.max_digits, 1)
    k_count, k_idx, k_scale, k_pos = jax.random.split(key, 4)
    lo, hi = cfg.scale_range
    draws = {
        "nums": jax.random.randint(k_count, (batch,), cfg.min_digits,
                                   cfg.max_digits + 1),
        "idx": jax.random.randint(k_idx, (batch, t_slots), 0, n_bank),
        "scale": jax.random.uniform(k_scale, (batch, t_slots), minval=lo,
                                    maxval=hi),
        "candidates": jax.random.uniform(
            k_pos, (batch, t_slots, cfg.place_attempts, 2), minval=-1.0,
            maxval=1.0),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


# canonical_uniform's and canonical_uniform28's data, and a crowded variant
# whose 5 slots reject often (IoU limit 0.05)
UNIFORM = {
    "canonical_uniform": jcfg.get_config("canonical_uniform").data,
    "canonical_uniform28": jcfg.get_config("canonical_uniform28").data,
    "five_slots_strict": jcfg.DataConfig(
        placement="uniform", max_digits=5, digit_size=(12, 12),
        canvas_size=(40, 40), scale_range=(0.7, 1.3), overlap_iou_max=0.05,
        place_attempts=3),
}


@pytest.mark.parametrize("name", sorted(UNIFORM))
def test_uniform_synthesis_matches_jax(name):
    """Canvases from the JAX draws at the f32 limit of the grid tests
    (rtol = atol = 1e-5); the picked candidates are the same."""
    cfg = UNIFORM[name]
    bank, _ = load_digit_bank("auto", cfg.digit_size)
    key = jax.random.key(4)
    imgs_j, nums_j, meta = jsynth.synthesize_batch(
        key, jnp.asarray(bank.numpy()), cfg, 32, return_meta=True)
    tc = tcfg.DataConfig(**dataclasses.asdict(cfg))
    draws = uniform_draws(key, cfg, 32, len(bank))
    imgs_t, nums_t = synthesize_batch(bank, tc, 32, draws=draws)
    assert np.array_equal(nums_t.numpy(), np.asarray(nums_j))
    np.testing.assert_allclose(imgs_t.numpy(), np.asarray(imgs_j),
                               rtol=1e-5, atol=1e-5)
    # the rejection picked the same candidate for every slot
    from attend_infer_repeat_torch.data.synth import _uniform_positions
    s = draws["scale"]
    sx = s * cfg.digit_size[1] / cfg.canvas_size[1]
    sy = s * cfg.digit_size[0] / cfg.canvas_size[0]
    tx, ty = _uniform_positions(draws["candidates"], sx, sy, tc)
    np.testing.assert_allclose(tx.numpy(), np.asarray(meta["tx"]), atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(meta["ty"]), atol=1e-6)


def test_uniform_draws_and_generator_path():
    cfg = tcfg.get_config("canonical_uniform").data
    d = sample_draws(cfg, 6, 100, torch.Generator().manual_seed(0), "cpu")
    assert d["candidates"].shape == (6, cfg.max_digits, cfg.place_attempts,
                                     2)
    assert "scores" not in d and "jitter" not in d
    assert float(d["candidates"].abs().max()) <= 1.0
    grid = sample_draws(tcfg.DataConfig(), 6, 100,
                        torch.Generator().manual_seed(0), "cpu")
    assert "candidates" not in grid
    bank, _ = load_digit_bank("auto", cfg.digit_size)
    imgs, nums = make_synth_fn(cfg, bank, device="cpu")(
        16, torch.Generator().manual_seed(1))
    assert imgs.shape == (16, 50, 50) and float(imgs.min()) >= 0.0
    assert float(imgs.max()) <= 1.0 and nums.dtype == torch.int32


@pytest.fixture(scope="module")
def mnist_npz(tmp_path_factory):
    """A small MNIST-format file: uint8 28×28 digits and labels."""
    rng = np.random.default_rng(0)
    images = (rng.random((40, 28, 28)) * 255 *
              (rng.random((40, 28, 28)) > 0.7)).astype(np.uint8)
    path = tmp_path_factory.mktemp("mnist") / "mnist.npz"
    np.savez(path, images=images, labels=rng.integers(0, 10, 40))
    return str(path)


@pytest.mark.parametrize("size", [(16, 16), (28, 28), (20, 20)],
                         ids=["down-28-16", "same", "down-28-20"])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_mnist_npz_bank_matches_jax(mnist_npz, size, split):
    """jax.image.resize "linear" antialiases when it downsamples; the port
    asks F.interpolate for it.  Measured apart by ≤ 3.6e-7; held to 1e-6."""
    ours, lab = load_digit_bank(f"mnist:{mnist_npz}", size, split)
    ref, ref_lab = jdigits.load_digit_bank(f"mnist:{mnist_npz}", size, split)
    assert ours.dtype == torch.float32 and tuple(ours.shape[1:]) == size
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert np.array_equal(lab.numpy(), np.asarray(ref_lab))


def test_mnist_pickle_bank_upsamples_as_jax(tmp_path):
    """An 8×8 pickle bank (no labels) upsampled to 16×16, as the bundled
    bank is: within 1e-6 of JAX."""
    rng = np.random.default_rng(1)
    path = tmp_path / "bank.pkl"
    with open(path, "wb") as f:
        pickle.dump({"imgs": rng.random((30, 8, 8)).astype(np.float32)}, f)
    ours, lab = load_digit_bank(f"mnist:{path}", (16, 16))
    ref, _ = jdigits.load_digit_bank(f"mnist:{path}", (16, 16))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    assert len(ours) == 27 and not lab.any()
    with pytest.raises(ValueError, match="unknown digit source"):
        load_digit_bank("emnist:x", (16, 16))


@pytest.fixture
def pickle_path(tmp_path):
    rng = np.random.default_rng(2)
    blob = {"imgs": (rng.random((25, 14, 14)) * 255).astype(np.uint8),
            "nums": rng.integers(0, 3, 25), "labels": rng.integers(0, 9, 25)}
    path = tmp_path / "train.pickle"
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return str(path)


def test_load_data_and_auto_split_match_jax(pickle_path):
    ours, ref = load_data(pickle_path), jloader.load_data(pickle_path)
    assert sorted(ours) == sorted(ref) == ["imgs", "labels", "nums"]
    for k in ours:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    assert float(ours["imgs"].max()) <= 1.0
    (tr, ev), (jtr, jev) = auto_split(ours), jloader.auto_split(ref)
    assert len(tr) == len(jtr) == 23 and len(ev) == len(jev) == 2
    np.testing.assert_array_equal(ev.imgs, jev.imgs)
    with pytest.raises(ValueError, match="too few"):
        auto_split({"imgs": ours["imgs"][:1], "nums": ours["nums"][:1]})


def test_in_memory_batches_match_jax(pickle_path):
    """Same permutations from the same seed; the ragged tail is dropped."""
    blob = load_data(pickle_path)
    ours = InMemoryDataset(blob["imgs"], blob["nums"]).batches(8, seed=3)
    ref = jloader.InMemoryDataset(blob["imgs"], blob["nums"]).batches(
        8, seed=3)
    for _ in range(7):                    # past two epochs of 3 batches
        (a, an), (b, bn) = next(ours), next(ref)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(an, bn)
        assert a.shape == (8, 14, 14)
    fixed = next(tensors_from_data(blob, 5, shuffle=False))
    np.testing.assert_array_equal(fixed[0], blob["imgs"][:5])
    with pytest.raises(ValueError, match="batch_size"):
        next(InMemoryDataset(blob["imgs"], blob["nums"]).batches(26))


def test_batch_iterator_uses_the_step_generators():
    """Batch s is what train step s of a state with that base seed
    synthesizes."""
    cfg = tcfg.DataConfig(canvas_size=(14, 14), digit_size=(8, 8))
    bank, _ = load_digit_bank("auto", (8, 8))
    synth = make_synth_fn(cfg, bank, device="cpu")
    it = batch_iterator(synth, 5, 4, device="cpu")
    for s in range(3):
        imgs, nums = next(it)
        ref, ref_nums = synth(4, step_generators(5, s, "cpu")[0])
        assert torch.equal(imgs, ref) and torch.equal(nums, ref_nums)
