"""Shared pieces of the benchmark's CPU tests: a cell cut to a tiny width
(the traffic, the seeds and the checks as in the committed cell), run on
the CPU, where the program runs its steps and requests eagerly."""

from __future__ import annotations

import copy

import pytest
import torch

from air_bench import layout

def tiny_config(cfg: dict) -> dict:
    """``cfg`` at tiny widths and batch, its switches and dtypes kept."""
    cfg = copy.deepcopy(cfg)
    m, t, d = cfg["model"], cfg["train"], cfg["data"]
    side = 12 * (m["img_size"][0] // 50)
    m.update(img_size=[side, side], glimpse_size=[4, 4], n_what=3,
             rnn_hidden=8, encoder_hidden=[8], glimpse_encoder_hidden=[8],
             decoder_hidden=[8], transform_hidden=[8], steps_hidden=[4],
             baseline_hidden=[8, 8])
    d.update(canvas_size=[side, side], digit_size=[4, 4])
    t.update(batch_size=8, scan_steps=4)
    return cfg


def iwae_trained(cfg: dict) -> dict:
    """``cfg`` trained as the ``iwae_trained`` preset trains
    ``canonical_fast``: the 5-particle bound with VIMCO, no baseline."""
    cfg = copy.deepcopy(cfg)
    cfg["name"] = "iwae_trained"
    cfg["train"].update(objective="iwae", iwae_particles=5,
                        use_baseline=False, iwae_eval_particles=5)
    return cfg


def tiny_cell(name: str, root=layout.ROOT) -> dict:
    """The cell at tiny widths, with the tiny settings its traffic kind
    keeps: ``traffic/<kind>.py``'s ``TINY`` traffic keys, and its
    ``tiny_config(cfg)``, where it has one, applied after ``tiny_config``
    to cut the kind's own sections."""
    cell = layout.cell(name, root)
    kind = layout.kind(cell["traffic_doc"]["kind"], root)
    cfg = tiny_config(cell["config_doc"]["config"])
    cfg = getattr(kind, "tiny_config", lambda c: c)(cfg)
    cell["config_doc"] = dict(cell["config_doc"], config=cfg)
    cell["traffic_doc"] = dict(cell["traffic_doc"],
                               **getattr(kind, "TINY", {}))
    return cell


CELLS = [p.stem for p in sorted((layout.ROOT / "workloads").glob("*.json"))]
#: Each cell's traffic kind.
KINDS = {c: layout.cell(c)["traffic_doc"]["kind"] for c in CELLS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
