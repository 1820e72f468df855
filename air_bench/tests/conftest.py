"""Shared pieces of the benchmark's CPU tests: a cell cut to a tiny width
(the traffic, the seeds and the checks as in the committed cell), run on
the CPU, where the program runs its steps and requests eagerly."""

from __future__ import annotations

import copy

import pytest
import torch

from air_bench import layout

#: Traffic parameters that keep a tiny cell's run short.
TINY_TRAFFIC = {
    "chunks": {"trace_chunks": 1},
    "closed_loop": {"batch": 16, "pool_batches": 2, "trace_requests": 2},
}


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


def tiny_cell(name: str) -> dict:
    cell = layout.cell(name)
    cell["config_doc"] = dict(cell["config_doc"],
                              config=tiny_config(cell["config_doc"]["config"]))
    kind = cell["traffic_doc"]["kind"]
    cell["traffic_doc"] = dict(cell["traffic_doc"], **TINY_TRAFFIC[kind])
    return cell


CELLS = [p.stem for p in sorted((layout.ROOT / "workloads").glob("*.json"))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
