"""What the serving cells share: the served model, the canvas pool, the
copy of each request's answers to the host, and their check.

The served model is the configuration's train state as
``create_train_state`` builds it, with the benchmark's weights, served
through ``make_infer_fn(config, model)``.  Each request draws its noise
from the run's noise generator, as a caller would pass it; the benchmark
keeps the generator's state before the requests it will check.  A
request's answers are ``mode_steps``, ``z_where`` and ``presence``,
copied to pinned host buffers; the canvas stays on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from air_bench import program
from air_bench.reference import compare, synth
from air_bench.reference.air import Model, sample_noise
from air_bench.reference.precision import Precision
from air_bench.yardstick import derived_seed, weights

KEYS = ("mode_steps", "z_where", "presence")
#: Rows of one reference forward.
BLOCK = 8192


class Server:
    """The program's served model and its infer entry."""

    def __init__(self, r):
        cfg = r.cfg
        self.weights = weights.make(cfg, cfg["train"]["use_baseline"],
                                    r.seed, r.device)
        self.state = program.train_state(cfg, self.weights, r.seed, r.device)
        self.infer = program.air().make_infer_fn(program.config(cfg),
                                                 self.state.model)
        self.gen = torch.Generator(r.device).manual_seed(
            derived_seed(r.seed, "noise"))

    def close(self) -> None:
        self.state = self.infer = None


def canvases(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` canvases of the configuration's scene in pinned host memory,
    synthesized on ``device`` from the run's pool seed."""
    bank = synth.digit_bank(cfg["data"]["digit_size"], device)
    gen = torch.Generator(device).manual_seed(derived_seed(seed, "pool"))
    out = torch.empty((n, *cfg["data"]["canvas_size"]), dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    for at in range(0, n, BLOCK):
        m = min(BLOCK, n - at)
        out[at:at + m].copy_(synth.synthesize(bank, cfg["data"], m, gen)[0])
    return out


class HostOut:
    """Pinned host buffers for the answers of requests of up to ``batch``
    images."""

    def __init__(self, cfg: dict, batch: int, device):
        t = cfg["model"]["max_steps"]
        pin = device.type == "cuda"
        self.device = device
        self.bufs = {"mode_steps": torch.empty((batch,), pin_memory=pin),
                     "z_where": torch.empty((batch, t, 4), pin_memory=pin),
                     "presence": torch.empty((batch, t), pin_memory=pin)}

    def fetch(self, out: dict, n: int) -> dict:
        """Copy the answers of ``out`` (``n`` images) to the host and wait;
        returns views of the buffers."""
        for k in KEYS:
            self.bufs[k][:n].copy_(out[k], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return {k: v[:n] for k, v in self.bufs.items()}


def finite(answers: dict) -> bool:
    """Whether a request's windows are finite (numpy: no wait for torch's
    CPU threads between requests)."""
    return bool(np.isfinite(answers["z_where"].numpy()).all())


def reference_answers(cfg: dict, w: dict, kept: list, device,
                      prec: Precision | None = None) -> dict:
    """The reference's answers to the requests ``kept``: ``(canvases on
    the host, noise generator state before the request, ...)``."""
    m = cfg["model"]
    model = Model(cfg, {k: v for k, v in w.items()
                        if not k.startswith("baseline.")}, prec)
    p = cfg["prior"]["final_success_prob"]
    imgs, noise = [], []
    for c, st, *_ in kept:
        g = torch.Generator(device)
        g.set_state(st)
        imgs.append(c)
        noise.append(sample_noise(m, c.shape[0], g, device))
    imgs = torch.cat(imgs)
    noise = tuple(torch.cat(parts, dim=1) for parts in zip(*noise))
    ref = {k: [] for k in KEYS}
    with torch.no_grad():
        for at in range(0, imgs.shape[0], BLOCK):
            sl = slice(at, at + BLOCK)
            out = model.forward(imgs[sl].to(device), p,
                                tuple(a[:, sl] for a in noise))
            ref["mode_steps"].append(out["mode_steps"].cpu())
            ref["z_where"].append(out["steps"]["z_where"].cpu())
            ref["presence"].append(out["steps"]["pres"].cpu())
    return {k: torch.cat(v) for k, v in ref.items()}


def check(r, w: dict, kept: list) -> dict:
    """The compared numbers of the requests ``kept``: ``(canvases on the
    host, noise generator state before the request, answers)``."""
    ref = reference_answers(r.cfg, w, kept, r.device)
    prog = {k: torch.cat([a[k] for _, _, a in kept]) for k in KEYS}
    return compare.judge(compare.serve_numbers(prog, ref), r.limits)
