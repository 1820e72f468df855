"""PyTorch port: Sequential AIR (``models/sqair.py``) against the
benchmark's plain reference (``air_bench/reference/sqair.py``), at tiny
widths on the CPU.

``air_bench/configs/sqair_k5.json`` is cut to tiny widths; the port's
``make_scan_train_step`` and the plain PyTorch reference (no JAX, no
kernels) start from the same seeded random weights
(``reference.sqair.make_weights``) and take the same steps on the same
sequences and particle draws: the reference regenerates the program's
step seeds, its sequence synthesis and each particle's noise in turn.
On the CPU both run the plain spatial transformer and the same matmul
mix, so they differ only by the order of f32 sums, and every presence
sample agrees.
"""

import collections
import copy
import dataclasses

import pytest
import torch

from air_bench import layout, program
from air_bench.reference import sqair as rsqair
from air_bench.reference import synth
from attend_infer_repeat_torch.configs import SequenceConfig
from attend_infer_repeat_torch.data.synth import (
    sample_sequence_draws,
    synthesize_sequences,
)
from attend_infer_repeat_torch.models import sqair
from attend_infer_repeat_torch.models.air import AIRModel
from attend_infer_repeat_torch.models.estimator import log_importance_weights
from attend_infer_repeat_torch.train.state import create_train_state

torch.set_num_threads(1)

STEPS = 3
CPU = torch.device("cpu")
EPS = torch.finfo(torch.float32).eps
#: The log-likelihood, both phases' KL estimates and the gradient's norm:
#: the same ops on the same draws on both sides, which sum in another
#: order (the plain spatial transformer's products, the gradient's sum of
#: squares): a few f32 roundings of the value.
RTOL = 1e-6
#: The loss and the bound are logsumexps of the particles' log weights,
#: sums over frames of terms of the log-likelihood's size: their rounding
#: is relative to the log weights, not to the result, which can lie near
#: 0.  So they are held to 16 f32 roundings of the mean |log weight|.
LOGW_ULPS = 16


def tiny_config(frames: int = 3, slots: int = 2) -> dict:
    """The committed configuration at tiny widths and batch, its
    objective, switches and dtypes kept."""
    cfg = copy.deepcopy(layout.load("configs", "sqair_k5")["config"])
    cfg["model"].update(
        img_size=[12, 12], glimpse_size=[4, 4], n_what=3, rnn_hidden=8,
        encoder_hidden=[8], glimpse_encoder_hidden=[8], decoder_hidden=[8],
        transform_hidden=[8], steps_hidden=[4], max_steps=slots)
    cfg["data"].update(canvas_size=[12, 12], digit_size=[4, 4])
    cfg["train"].update(batch_size=8, scan_steps=STEPS)
    cfg["sequence"].update(frames=frames, temporal_hidden=8,
                           relation_hidden=8, prior_hidden=8,
                           proposal_hidden=[8])
    return cfg


def seq_config(cfg: dict) -> SequenceConfig:
    return SequenceConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg["sequence"].items()})


def state_of(cfg: dict, seed: int):
    state = create_train_state(program.config(cfg), seed=seed, device=CPU,
                               sequence=seq_config(cfg))
    program.load_weights(state.model, rsqair.make_weights(cfg, seed, CPU))
    return state


def bank_of(cfg: dict):
    return synth.digit_bank(cfg["data"]["digit_size"], CPU)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 4_000_000_017])
def test_sqair_steps_match_the_plain_reference(seed):
    cfg = tiny_config()
    bank = bank_of(cfg)
    state = state_of(cfg, seed)
    scan = program.air().make_scan_train_step(program.config(cfg),
                                              state.model, bank, STEPS)
    state, rows = scan(state)
    ref = rsqair.Trainer(cfg, rsqair.make_weights(cfg, seed, CPU), bank,
                         seed).follow(STEPS)
    assert state.step == STEPS
    for key in ("loss", "iwae_bound", "log_likelihood", "kl_prop", "kl_disc",
                "grad_norm"):
        for s in range(STEPS):
            got, want = rows[key][s].item(), ref[key][s]
            if key in ("loss", "iwae_bound"):
                tol = LOGW_ULPS * EPS * ref["log_w_abs"][s]
            else:
                tol = RTOL * abs(want)
            assert abs(got - want) <= tol, (key, s + 1, got, want)


def forward_pair(cfg, seed, k=5):
    """One step-0 forward of the port's wide ``k``-particle model and the
    reference's k forwards, on the same weights, sequences and draws."""
    state = state_of(cfg, seed)
    model = state.model
    trainer = rsqair.Trainer(cfg, rsqair.make_weights(cfg, seed, CPU),
                             bank_of(cfg), seed)
    imgs, _, noises = trainer.batch(0)
    noises = noises[:k]
    p = torch.tensor(0.7)
    with torch.no_grad():
        out = model(imgs.repeat(k, 1, 1, 1), p,
                    noise=tuple(torch.cat(parts, dim=2)
                                for parts in zip(*noises)), particles=k)
        ref = [rsqair.SQAIR(cfg, trainer.params).forward(imgs, p, n)
               for n in noises]
    return out, ref, imgs, noises, model


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 3])
def test_each_particle_and_frame_matches_the_reference(seed):
    """Per particle and frame: the log weight within f32 roundings, and
    every presence sample of both phases, and the compacted slots, equal."""
    cfg = tiny_config()
    out, ref, imgs, _, _ = forward_pair(cfg, seed)
    batch = imgs.shape[0]
    for j, r in enumerate(ref):
        rows = slice(j * batch, (j + 1) * batch)
        got = out.frame_log_weight[rows]
        scale = torch.mean(torch.abs(r["frame_log_w"]))
        assert torch.allclose(got, r["frame_log_w"], rtol=0,
                              atol=LOGW_ULPS * EPS * float(scale)), j
        for key in ("prop_pres", "disc_pres", "pres"):
            assert torch.equal(getattr(out, key)[rows], r[key]), (j, key)


def test_frame_one_is_air():
    """Frame 1 has no earlier objects: its discovery is ``AIRModel``'s
    forward on the same weights and noise, its log weight AIR's."""
    cfg = tiny_config()
    out, _, imgs, noises, model = forward_pair(cfg, 7, k=1)
    air = AIRModel(model.cfg, use_baseline=False, device=CPU)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in air.named_parameters():
            p.copy_(own[name])
        _, _, _, dw, dwhat, du = noises[0]
        got = air(imgs[:, 0], torch.tensor(0.7), noise=(dw[0], dwhat[0],
                                                        du[0]))
        want = log_importance_weights(got, model.cfg, torch.tensor(0.7),
                                      where_prior=air.where_prior())
    assert torch.equal(out.disc_pres[:, 0], got.steps.pres)
    assert torch.equal(out.prop_pres[:, 0], torch.zeros_like(
        out.prop_pres[:, 0]))
    assert torch.allclose(out.frame_log_weight[:, 0], want, rtol=1e-6,
                          atol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_presence_rules(seed):
    """Propagated presence only switches off, discovery never fills more
    than the free slots, and compaction keeps every present object, first
    the propagated ones: the slots read ones, then zeros."""
    cfg = tiny_config(frames=5, slots=3)
    cfg["sequence"].update(max_entry_frame=2)
    out, _, _, _, _ = forward_pair(cfg, seed)
    assert torch.all(out.prop_pres <= out.prop_prev)
    assert torch.equal(out.prop_prev[:, 1:], out.pres[:, :-1])
    assert torch.all(out.disc_pres.sum(-1) <= out.free)
    assert torch.equal(out.free, 3 - out.prop_pres.sum(-1))
    assert torch.equal(out.pres.sum(-1),
                       out.prop_pres.sum(-1) + out.disc_pres.sum(-1))
    assert torch.all(out.pres[..., 1:] <= out.pres[..., :-1])
    assert out.disc_pres[:, 1:].sum() > 0          # discovery after frame 1
    assert out.prop_pres.sum() > 0


def test_compaction_is_a_stable_gather():
    """Present propagated objects keep their order ahead of the present
    discovered ones; each carries its states, a discovered one zero
    states, an absent slot zeros."""
    cfg = tiny_config(slots=3)
    model = state_of(cfg, 0).model
    n, d = 3, 8

    def obj(value, present):
        return torch.full((1, n, 1), float(value)) * torch.tensor(
            [1.0, 2.0, 3.0])[None, :, None], torch.tensor(
            present, dtype=torch.float32)[None, :, None]

    what, pres = obj(1, [0, 1, 1])
    prop = {"z_what": what.expand(-1, -1, 3), "z_where": what.expand(
        -1, -1, 4), "pres": pres,
        "temporal": (what.expand(-1, -1, d) + 10, what.expand(-1, -1, d)),
        "prior": (what.expand(-1, -1, d) + 20, what.expand(-1, -1, d))}
    dwhat, dpres = obj(-1, [1, 0, 0])
    disc = type("Disc", (), dict(z_what=dwhat.expand(-1, -1, 3),
                                 z_where=dwhat.expand(-1, -1, 4),
                                 pres=dpres[..., 0]))
    what, where, pres, temporal, prior = model._compact(prop, disc)
    assert what[0, :, 0].tolist() == [2.0, 3.0, -1.0]
    assert pres[0, :, 0].tolist() == [1.0, 1.0, 1.0]
    assert temporal[0][0, :, 0].tolist() == [12.0, 13.0, 0.0]
    assert prior[0][0, :, 0].tolist() == [22.0, 23.0, 0.0]
    dpres.zero_()
    what, _, pres, _, _ = model._compact(prop, type(
        "Disc", (), dict(z_what=disc.z_what, z_where=disc.z_where,
                         pres=dpres[..., 0])))
    assert what[0, :, 0].tolist() == [2.0, 3.0, 0.0]
    assert pres[0, :, 0].tolist() == [1.0, 1.0, 0.0]


def test_sqair_counts_a_forward():
    """A forward at T = 10 frames and N = 3 slots counts 10 frames, 30
    propagation and 30 discovery object steps."""
    cfg = tiny_config(frames=10, slots=3)
    model = state_of(cfg, 0).model
    before = collections.Counter(sqair.sqair_counts)
    with torch.no_grad():
        model(torch.rand(2, 10, 12, 12), torch.tensor(0.5),
              generator=torch.Generator().manual_seed(0))
    assert sqair.sqair_counts - before == {"frames": 10, "prop_steps": 30,
                                           "disc_steps": 30}


def test_sequences_match_the_reference_synthesis():
    """The port's sequences are the reference's from the same generator
    state; each digit stays inside the frame and appears from its entry
    frame on."""
    cfg = tiny_config(frames=8)
    cfg["data"].update(canvas_size=[20, 20], min_digits=1)
    cfg["sequence"].update(max_speed=6.0)
    bank = bank_of(cfg)
    seq, data = seq_config(cfg), program.config(cfg).data
    got, nums = synthesize_sequences(bank, data, seq, 64,
                                     torch.Generator().manual_seed(5))
    want, ref_nums = rsqair.synthesize(bank, cfg["data"], cfg["sequence"],
                                       64, torch.Generator().manual_seed(5))
    assert torch.equal(nums, ref_nums)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (64, 8, 20, 20)
    draws = sample_sequence_draws(data, seq, 64, bank.shape[0],
                                  torch.Generator().manual_seed(5))
    assert torch.equal(draws["nums"].to(torch.int32), nums)
    mass = got.sum(dim=(-2, -1))
    for b in torch.nonzero(nums == 1)[:, 0].tolist():
        e = int(draws["entry"][b, 0])
        assert torch.all(mass[b, :e] == 0), b
        # it stays in the frame: no frame loses most of its ink
        assert mass[b, e:].min() > 0.5 * mass[b, e:].max(), b


def test_air_cell_without_mask_is_unchanged():
    """``AIRCell`` with an all-ones slot mask gives its unmasked step, bit
    for bit."""
    cfg = tiny_config()
    model = state_of(cfg, 9).model
    from attend_infer_repeat_torch.models.cell import initial_carry

    img = torch.rand(4, 12, 12)
    g = torch.Generator().manual_seed(1)
    eps_w, eps_what, u = (torch.randn(4, 3, generator=g),
                          torch.randn(4, 3, generator=g),
                          torch.rand(4, 1, generator=g))
    with torch.no_grad():
        a, oa = model.cell(initial_carry(model.cfg, img), img, model.decoder,
                           eps_w, eps_what, u)
        b, ob = model.cell(initial_carry(model.cfg, img), img, model.decoder,
                           eps_w, eps_what, u, free=torch.ones(4, 1))
        c, oc = model.cell(initial_carry(model.cfg, img), img, model.decoder,
                           eps_w, eps_what, u, free=torch.zeros(4, 1))
    assert torch.equal(a[0], b[0])
    for f in dataclasses.fields(oa):
        assert torch.equal(getattr(oa, f.name), getattr(ob, f.name)), f.name
    assert torch.equal(oc.pres, torch.zeros(4))
    assert torch.equal(oc.pres_prev, torch.zeros(4))


def test_create_train_state_builds_sqair():
    """One ``model`` group, no baseline; the NVIL baseline is refused."""
    cfg = tiny_config()
    state = state_of(cfg, 0)
    assert isinstance(state.model, sqair.SQAIRModel)
    assert sorted(state.opt_state) == ["baseline", "model"]
    assert not state.opt_state["baseline"].nu
    assert len(state.opt_state["model"].nu) == len(
        rsqair.param_shapes(cfg))
    with pytest.raises(ValueError, match="baseline"):
        create_train_state(dataclasses.replace(
            program.config(cfg), train=dataclasses.replace(
                program.config(cfg).train, use_baseline=True)),
            device=CPU, sequence=seq_config(cfg))
