"""Measure a supervised CNN's count-accuracy ceiling on the synthetic
scenes, with the PyTorch port.

The port's counterpart of ``scripts/supervised_ceiling.py``, with the same
flags and output plus ``--device`` (default ``cuda``; with no card it
raises unless given ``--device cpu``).  A small convnet (``CountCNN``) is
trained on (canvas → digit count) labels, which AIR never sees, on freshly
synthesized train-split batches of the preset, with Adam; it is then
evaluated on the held-out scenes of
``scripts/torch_analyze_overlap_errors.py`` (the eval-split bank, the same
generator seeds) and binned by the same ``overlap_bins``.  Its accuracy
bounds what any counting method reaches on that data.

    python3 scripts/torch_supervised_ceiling.py --config canonical_uniform28 \\
        --steps 30000 --out runs/supervised_ceiling_u28.json

Train step ``s`` synthesizes its batch from a generator seeded from
``(seed + 1, s)``: the JAX script's ``fold_in(key(seed + 1), s)``.  On the
card the train step and the prediction are CUDA graphs
(``utils/graphs.py``), the step's draws taken outside the replay; eager on
the CPU and inside ``utils.debug_mode``.  Convolutions and matmuls run in
f32: TF32 is off and cuDNN picks deterministic algorithms while the tool
runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPTS))
sys.path.insert(0, _SCRIPTS)

from attend_infer_repeat_torch import resolve_device  # noqa: E402
from attend_infer_repeat_torch.configs import get_config  # noqa: E402
from attend_infer_repeat_torch.data import (  # noqa: E402
    load_digit_bank,
    synthesize_batch,
)
from attend_infer_repeat_torch.data.synth import sample_draws  # noqa: E402
from attend_infer_repeat_torch.models.modules import init_params  # noqa: E402
from attend_infer_repeat_torch.ops.math import seeded_generator  # noqa: E402
from attend_infer_repeat_torch.utils import graphs  # noqa: E402
from torch_analyze_overlap_errors import (  # noqa: E402
    heldout_scenes,
    overlap_bins,
    scene_max_iou,
)


class CountCNN(nn.Module):
    """Three blocks of 3×3 conv ("same" padding), ReLU and 2×2 max-pool
    (50 → 25 → 12 → 6), a global mean, then ``Linear(128)``, ReLU and the
    count logits.  Initialized as flax initializes the JAX script's
    ``CountCNN``; its layers are named so that ``convert.params_from_flax``
    turns that model's parameters into this one's ``state_dict``
    (``Conv_k`` → ``conv.k``, ``Dense_k`` → ``dense.k``)."""

    def __init__(self, n_classes: int, device=None, seed: int = 0):
        super().__init__()
        widths = (1, 32, 64, 128)
        self.conv = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1)
                                  for a, b in zip(widths[:-1], widths[1:]))
        self.dense = nn.ModuleList([nn.Linear(128, 128),
                                    nn.Linear(128, n_classes)])
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x):
        x = x[:, None]
        for conv in self.conv:
            x = F.max_pool2d(F.relu(conv(x)), 2)
        x = x.mean(dim=(2, 3))
        return self.dense[1](F.relu(self.dense[0](x)))


def make_optimizer(model: CountCNN, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s rule (eps outside the root) with its state made
    now, on the model's device, so that a graph holds it from the start
    (``capturable`` on CUDA: the step count stays on the card)."""
    cuda = model.conv[0].weight.is_cuda
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=cuda)
    for p in model.parameters():
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32,
                                device=p.device if cuda else "cpu"),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    return opt


def optimizer_tensors(opt) -> list:
    """Every tensor of ``opt``'s state, in parameter order."""
    return [t for group in opt.param_groups for p in group["params"]
            for t in opt.state[p].values()]


@contextlib.contextmanager
def f32_exact():
    """TF32 off for matmuls and convolutions, deterministic cuDNN; the
    previous settings put back after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def make_train_step(model: CountCNN, opt, data_cfg, bank, batch_size: int):
    """``step(generator=None, draws=None) → (loss, accuracy)``: one Adam
    step of ``model`` on a batch synthesized from ``generator``'s draws
    (or the given ``draws``, as ``sample_draws`` returns them), the
    cross-entropy of the count logits its loss.  On CUDA one CUDA graph,
    captured at the first call (the parameters and the optimizer state put
    back after its warm-up); eager on the CPU and inside
    ``utils.debug_mode``."""
    params = list(model.parameters())
    graph, static = None, None

    def body(draws):
        imgs, nums = synthesize_batch(bank, data_cfg, batch_size,
                                      draws=draws)
        logits = model(imgs)
        nums = nums.long()
        loss = F.cross_entropy(logits, nums)
        acc = (logits.argmax(-1) == nums).float().mean()
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()
        return loss.detach(), acc

    def step(generator=None, draws=None):
        nonlocal graph, static
        if draws is None:
            draws = sample_draws(data_cfg, batch_size, bank.shape[0],
                                 generator, bank.device)
        if graphs.eager(bank.device):
            return body(draws)
        if graph is None:
            static = graphs.static_like(draws, bank.device)
            graph = graphs.Graph(lambda: body(static), bank.device,
                                 state=[*params, *optimizer_tensors(opt)])
        else:
            graphs.fill(static, draws)
        return graphs.copy(graph.launch())

    step.graph = lambda: graph
    return step


def make_predict(model: CountCNN):
    """``predict(imgs) → counts``, the argmax of the logits; on CUDA a CUDA
    graph per batch shape, eager on the CPU and inside
    ``utils.debug_mode``."""
    cache = graphs.GraphCache(lambda m, imgs: m(imgs).argmax(-1))

    @torch.no_grad()
    def predict(imgs):
        if graphs.eager(imgs.device):
            return model(imgs).argmax(-1)
        return cache(model, imgs)

    predict.graphs = cache
    return predict


def train_ceiling(model, opt, cfg, bank, steps: int, batch_size: int,
                  seed: int, log_every: int = 2000):
    """``steps`` Adam steps on train-split batches, step ``s`` from a
    generator seeded from ``(seed + 1, s)``; prints the loss and accuracy
    every ``log_every`` steps and at the last.  Returns the step
    (``make_train_step``)."""
    step_fn = make_train_step(model, opt, cfg.data, bank, batch_size)
    for s in range(steps):
        loss, acc = step_fn(seeded_generator(bank.device, seed + 1, s))
        if s % log_every == 0 or s == steps - 1:
            print(f"[{s}] loss={float(loss):.4f} "
                  f"train_acc={float(acc):.4f}", flush=True)
    return step_fn


def evaluate_ceiling(predict, scenes):
    """``(max_iou, true counts, predicted counts)`` over ``scenes``
    (``heldout_scenes``)."""
    max_ious, trues, preds = [], [], []
    for imgs, nums, meta in scenes:
        preds.append(predict(imgs).cpu().numpy().astype(int))
        trues.append(nums.cpu().numpy().astype(int))
        max_ious.append(scene_max_iou(
            {k: v.cpu().numpy() for k, v in meta.items()}))
    return tuple(np.concatenate(a) for a in (max_ious, trues, preds))


def main(argv=None) -> dict:
    """Train and evaluate the probe; returns what it wrote to ``--out``."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="canonical_uniform28")
    p.add_argument("--steps", type=int, default=30_000)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--eval-batch-size", type=int, default=1024)
    p.add_argument("--eval-seed", type=int, default=1234,
                   help="same held-out stream as "
                        "torch_analyze_overlap_errors.py")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train (default cuda; never falls back)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    train_bank = load_digit_bank(cfg.data.source, cfg.data.digit_size,
                                 split="train")[0].to(dev)
    eval_bank = load_digit_bank(cfg.data.source, cfg.data.digit_size,
                                split="eval")[0].to(dev)
    model = CountCNN(cfg.data.max_digits + 1, device=dev, seed=args.seed)
    opt = make_optimizer(model, args.lr)
    with f32_exact():
        train_ceiling(model, opt, cfg, train_bank, args.steps,
                      args.batch_size, args.seed)
        # held-out evaluation: the protocol and binning of
        # torch_analyze_overlap_errors.py (same eval-split bank, same
        # generator seeds), so the bins compare directly with AIR's
        scenes = heldout_scenes(cfg, eval_bank, args.eval_batches,
                                args.eval_batch_size, args.eval_seed)
        bins = overlap_bins(*evaluate_ceiling(make_predict(model), scenes))
    result = {
        "config": args.config,
        "probe": "supervised CountCNN (3-block conv, GAP head)",
        "train_steps": args.steps,
        "n_scenes": args.eval_batches * args.eval_batch_size,
        "supervised_accuracy": round(bins["accuracy"], 4),
        "bins": bins["table"],
    }
    print(json.dumps(result, indent=1))
    out = args.out or f"runs/supervised_ceiling_{args.config}.json"
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}", flush=True)
    return result


if __name__ == "__main__":
    main()
