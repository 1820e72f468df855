"""The yardstick of ``scripts/torch_quality.py``: the reference runs it reads
are runs of today's presets, and its bars follow from them.

Runs on the CPU with no card.  For each reference run in the script's
``REFERENCES``, the ``config:`` line of ``runs/<run>.log`` (the JAX CLI's
print of the four config dataclasses) is compared field by field with the
port's ``configs.get_config(<preset>)``: only ``seed`` may differ, and a
field the log predates must hold its default in the preset.  The bar
logic is checked on the committed ``metrics.jsonl`` files.
"""

import ast
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest

from attend_infer_repeat_torch import configs as tcfg

ROOT = Path(__file__).resolve().parent.parent


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "torch_quality", ROOT / "scripts" / "torch_quality.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


quality = _load_script()

RUNS = [(preset, p.name) for preset, ref in sorted(quality.REFERENCES.items())
        for p in sorted((ROOT / "runs").glob(ref.runs)) if p.is_dir()]
SECTIONS = {"model": tcfg.ModelConfig, "train": tcfg.TrainConfig,
            "prior": tcfg.PriorAnnealConfig, "data": tcfg.DataConfig}


def logged_config(run):
    """``(preset name, {section: {field: value}})`` from the ``config:``
    line of ``runs/<run>.log``."""
    line = next(s for s in (ROOT / "runs" / f"{run}.log").read_text()
                .splitlines() if s.startswith("config: "))
    name, rest = line[len("config: "):].split(None, 1)
    sections = {}
    for part in rest.split("  "):
        section, call = part.split("=", 1)
        node = ast.parse(call, mode="eval").body
        assert node.func.id == SECTIONS[section].__name__, part
        sections[section] = {kw.arg: ast.literal_eval(kw.value)
                             for kw in node.keywords}
    return name, sections


def as_logged(value):
    """A config value as the log's literal reads back (lists as tuples)."""
    return tuple(value) if isinstance(value, list) else value


def test_every_preset_has_reference_runs():
    found = {preset for preset, _ in RUNS}
    assert found == set(quality.REFERENCES)
    assert len(RUNS) == 3 + 3 + 3 + 1 + 6 + 1


@pytest.mark.parametrize("preset,run", RUNS, ids=[r for _, r in RUNS])
def test_reference_run_is_todays_preset(preset, run):
    """Field by field: equal but for ``seed``; a field the log lacks holds
    its default in the preset."""
    name, logged = logged_config(run)
    assert name == preset
    cfg = tcfg.get_config(preset)
    assert set(logged) == set(SECTIONS)
    for section, cls in SECTIONS.items():
        ours = getattr(cfg, section)
        names = {f.name for f in dataclasses.fields(cls)}
        assert set(logged[section]) <= names, (section, set(
            logged[section]) - names)
        for f in dataclasses.fields(cls):
            have = getattr(ours, f.name)
            if f.name not in logged[section]:
                assert have == f.default, (run, section, f.name, have)
            elif (section, f.name) != ("train", "seed"):
                assert logged[section][f.name] == as_logged(have), (
                    run, section, f.name, logged[section][f.name], have)


def test_at_takes_the_last_row_of_a_split_at_a_step(tmp_path):
    rows = [{"step": 500, "split": "eval", "elbo": 1.0},
            {"step": 500, "split": "train", "elbo": 2.0},
            {"step": 1000, "split": "eval", "elbo": 3.0},
            # a basin restart sends the step back and logs it again
            {"step": 500, "split": "eval", "elbo": 4.0}]
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    rows = quality.rows_of(path)
    assert quality.at(rows, "eval", 500)["elbo"] == 4.0
    assert quality.at(rows, "train", 500)["elbo"] == 2.0
    assert quality.at(rows, "eval", 1500) is None
    # cfv6_seed2 restarted once at its basin check, so it logged step
    # 10,000 twice: the second attempt's row counts
    ref = quality.reference_runs("canonical_fast")["cfv6_seed2"]
    basin = [r for r in ref if r["split"] == "basin"]
    assert [r["attempt"] for r in basin] == [0.0, 1.0]
    assert quality.at(ref, "basin", 10_000)["attempt"] == 1.0


# The bars at each preset's step: lowest reference seed less 0.005 (at
# most the highest plus 0.05 for the collapsing ablation) and the ELBO
# range widened by 10 nats, as read from the committed runs.
BARS = {
    "canonical_fast": (10_000, 0.9950, (2366.8, 2390.6)),
    "canonical_uniform": (20_000, 0.9928, (2337.8, 2362.6)),
    "canonical_uniform28": (20_000, 0.9873, (2302.7, 2327.2)),
    "iwae_trained": (10_000, 0.9949, (2369.0, 2389.0)),
    "crowded": (50_000, 0.9884, (9578.1, 9620.9)),
    "no_nvil": (10_000, 0.0500, (2347.7, 2367.7)),
}


@pytest.mark.parametrize("preset", sorted(BARS))
def test_bars_from_the_reference_runs(preset):
    step, acc, (lo, hi) = BARS[preset]
    assert quality.REFERENCES[preset].step == step
    acc_bar, kind, (elbo_lo, elbo_hi) = quality.bars(preset, step)
    assert kind == ("max" if preset == "no_nvil" else "min")
    assert acc_bar == pytest.approx(acc, abs=5e-5)
    assert (elbo_lo, elbo_hi) == (pytest.approx(lo, abs=0.05),
                                  pytest.approx(hi, abs=0.05))
    # every reference run logged the step and meets its own bars
    refs = quality.reference_at(preset, step)
    assert len(refs) == sum(p == preset for p, _ in RUNS)
    for run, (a, e) in refs.items():
        assert quality.meets(preset, step, a, e) == (True, True), run
    # and a run off the bars misses them
    worst = min(a for a, _ in refs.values())
    off = acc_bar + 0.01 if kind == "max" else acc_bar - 1e-4
    assert quality.meets(preset, step, off, elbo_lo + 1.0) == (False, True)
    assert quality.meets(preset, step, worst, elbo_hi + 0.1) == (True, False)
    assert quality.meets(preset, step, worst, elbo_lo - 0.1) == (True, False)


def test_crowded_bars_at_40000_past_the_cap_switch():
    """The fallback step for a call that cannot hold 50,000 steps: the
    reference seeds ranged 0.9771-1.0 there."""
    cap = tcfg.get_config("crowded").model.max_scale_from_step
    assert cap < 40_000
    acc_bar, kind, (lo, hi) = quality.bars("crowded", 40_000)
    assert kind == "min" and acc_bar == pytest.approx(0.97705 - 0.005,
                                                      abs=1e-5)
    assert lo < 9574.9 - 9.9 and hi > 9612.7 + 9.9
    with pytest.raises(ValueError, match="logged step"):
        quality.bars("crowded", 40_001)


def test_wall_per_500_reads_one_attempt():
    rows = [{"step": 500, "split": "train", "wall_s": 10.0},
            {"step": 1000, "split": "train", "wall_s": 13.0},
            {"step": 1500, "split": "train", "wall_s": 17.0},
            {"step": 500, "split": "train", "wall_s": 30.0},   # restart
            {"step": 1000, "split": "train", "wall_s": 32.0}]
    assert quality.wall_per_500(rows) == 3.0
    assert quality.wall_per_500(rows[:1]) is None
