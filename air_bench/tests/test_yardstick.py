"""The benchmark's arithmetic against hand counts and against the program."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from air_bench import layout, program, serve
from air_bench.tests.conftest import tiny_config
from air_bench.yardstick import flops, peaks, st_bytes

HBM = peaks.H100_SXM["hbm_bytes_s"]


def config(name):
    return layout.load("configs", name)["config"]


# --- FLOPs ----------------------------------------------------------------

def _hand_forward(cfg):
    """One image's forward, written out: ``(bf16 or dtype FLOPs, f32)``."""
    m = cfg["model"]
    t = m["max_steps"]
    hw = m["img_size"][0] * m["img_size"][1]
    d_where = 3
    stated = 2 * t * (hw * 256            # encoder
                      + 256 * 256 + 2 * 256 * d_where    # where MLP, head
                      + 400 * 256 + 2 * 256 * 50          # what MLP, head
                      + 360 * 128)                        # presence MLP
    feats = 2 * d_where + 4 + 50 + 2 + t                  # baseline inputs
    stated += 2 * (hw * 256 + t * feats * 256             # baseline layer 0
                   + t * 256 * 256 + t * 256)             # layers 1, 2
    f32 = 2 * t * (311 * 1024 + 256 * 1024                # LSTM
                   + 128                                   # presence logit
                   + 50 * 256 + 256 * 400)                 # decoder
    return stated, f32


def test_flops_match_hand_counts():
    fast, crowded = config("canonical_fast"), config("crowded")
    s, f = _hand_forward(fast)
    assert flops.per_image(fast, False, True) == {"bfloat16": s,
                                                  "float32": f}
    assert flops.per_image(fast, True, True) == {"bfloat16": 3 * s,
                                                 "float32": 3 * f}
    # canonical_fast: 21.18 MFLOP bf16 and 12.53 MFLOP f32 a train step's
    # image; crowded, all f32 on 100x100 with 5 steps, 122.76 MFLOP
    assert round(3 * s / 1e6, 2) == 21.18 and round(3 * f / 1e6, 2) == 12.53
    s, f = _hand_forward(crowded)
    assert flops.per_image(crowded, True, True) == {"float32": 3 * (s + f)}
    assert round(3 * (s + f) / 1e6, 2) == 122.76


@pytest.mark.parametrize("name", ["canonical_fast", "crowded"])
def test_flops_match_the_programs_linears(name):
    """The counted linears are those the program's forward multiplies."""
    cfg = config(name)
    model = program.air().AIRModel(program.config(cfg).model,
                                   use_baseline=True, device="cpu")
    x = torch.rand((2, *cfg["model"]["img_size"]))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, 0.5, generator=torch.Generator().manual_seed(0))
    counts = fc.get_flop_counts()["Global"]
    aten = torch.ops.aten
    linear = sum(counts.get(op, 0) for op in (aten.mm, aten.addmm))
    assert linear == 2 * sum(flops.per_image(cfg, False, True).values())


# --- ST bytes -------------------------------------------------------------

def test_st_bytes_match_the_recorded_bounds():
    fast, crowded = config("canonical_fast"), config("crowded")
    us = {k: v / HBM * 1e6 for k, v in st_bytes.train_step(fast).items()}
    assert (round(us["forward"], 2), round(us["backward"], 2)) == (28.05,
                                                                   22.80)
    us = {k: v / HBM * 1e6 for k, v in st_bytes.train_step(crowded).items()}
    assert (round(us["forward"], 2), round(us["backward"], 2)) == (189.93,
                                                                   129.70)
    gather = st_bytes.gather(8192, (50, 50), (20, 20)) / HBM * 1e6
    assert round(gather, 2) == 28.41
    assert st_bytes.request(fast, 8192) == 3 * 2 * st_bytes.gather(
        8192, (50, 50), (20, 20))


@pytest.mark.parametrize("name", ["canonical_fast", "crowded"])
def test_image_gradient_asked_for_pastes_only(name, monkeypatch):
    """``st_bytes`` writes ``g_img`` for a paste's backward and not for a
    gather's: as the model's autograd asks for it."""
    from attend_infer_repeat_torch.ops import st_kernel

    cfg = tiny_config(config(name))
    seen = []
    plain = st_kernel.st_gather_bwd_plain

    def record(img, zw, g, out_shape, compute_dtype="float32",
               need_img=True):
        seen.append((tuple(img.shape[-2:]), tuple(out_shape), need_img))
        return plain(img, zw, g, out_shape, compute_dtype, need_img)

    monkeypatch.setattr(st_kernel, "st_gather_bwd_plain", record)
    air = program.air()
    state = air.create_train_state(program.config(cfg), seed=0, device="cpu")
    bank = torch.rand((5, *cfg["data"]["digit_size"]))
    air.make_train_step(program.config(cfg), state.model, digit_bank=bank)(
        state)
    glimpse, canvas = (tuple(cfg["model"][k]) for k in ("glimpse_size",
                                                         "img_size"))
    assert sorted(seen) == sorted(
        [(glimpse, canvas, True), (canvas, glimpse, False)]
        * cfg["model"]["max_steps"])


# --- configurations and traffic ---------------------------------------------

@pytest.mark.parametrize("name", ["canonical_fast", "crowded"])
def test_config_file_is_the_preset(name):
    doc = layout.load("configs", name)
    built = program.config(doc["config"])
    preset = program.air().get_config(doc["preset"])
    assert built == preset
    assert doc["reduced"] == []
    assert dataclasses.asdict(built) == dataclasses.asdict(preset)


def test_canvases_are_the_seeds():
    cfg = config("canonical_fast")
    cpu = torch.device("cpu")
    a = serve.canvases(cfg, 40, 2 ** 32 + 1, cpu)
    b = serve.canvases(cfg, 40, 2 ** 32 + 1, cpu)
    c = serve.canvases(cfg, 40, 2 ** 32 + 2, cpu)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (40, 50, 50) and 0.0 <= a.min() and a.max() <= 1.0
