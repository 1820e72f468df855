"""What the benchmark takes from the program under test.

The program is ``attend_infer_repeat_torch`` of the checkout the run
starts in: its configuration classes, its train state and step, its
serving entry, and its kernel launch counters and graph pools.  The
configuration comes from the benchmark's file, not from the program's
presets, and the weights are the benchmark's (``yardstick.weights``),
copied into the program's model in place.
"""

from __future__ import annotations

import gc


def air():
    import attend_infer_repeat_torch

    return attend_infer_repeat_torch


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config(doc: dict):
    """The program's ``Config`` of a configuration dict."""
    from attend_infer_repeat_torch import configs as c

    sections = {"model": c.ModelConfig, "prior": c.PriorAnnealConfig,
                "train": c.TrainConfig, "data": c.DataConfig}
    kw = {k: cls(**{f: _tuples(v) for f, v in doc[k].items()})
          for k, cls in sections.items()}
    return c.Config(name=doc["name"], **kw)


def train_state(cfg: dict, weights: dict, seed: int, device):
    """A fresh train state of the program with the benchmark's weights."""
    state = air().create_train_state(config(cfg), seed=seed, device=device)
    load_weights(state.model, weights)
    return state


def load_weights(model, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters, name for name."""
    import torch

    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(weights):
        raise ValueError(f"the program's parameters {names} are not the "
                         f"benchmark's {sorted(weights)}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])


def launches() -> tuple:
    """The kernels' launch counts: forward, backward."""
    from attend_infer_repeat_torch.ops import st_kernel

    return st_kernel.launches, st_kernel.bwd_launches


def graph_pools(entry) -> list:
    """Each graph's pool (bytes) of an entry point that keeps ``graphs``."""
    out = []
    for g in getattr(entry, "graphs", {}).values():
        graph = getattr(g, "graph", g)
        if hasattr(graph, "pool_bytes"):
            out.append(graph.pool_bytes)
    return out


def free(device) -> None:
    """Give back what the program's objects held, once they are dropped."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

