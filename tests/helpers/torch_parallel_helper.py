"""Subprocess helper for the PyTorch port's data-parallel tests.

One rank of a gloo process group on the CPU, with JAX and the JAX package
blocked from import.  The ranks meet through a ``FileStore`` (no ports)::

    python tests/helpers/torch_parallel_helper.py --case mesh_step \
        --rank 0 --world 2 --store <file> --inputs <in.pt> --out <out.pt>

``--inputs`` (``torch.save``) holds the case's ``config`` (as
``dataclasses.asdict``) and whatever else it needs; the rank writes what
it computed to ``--out``: 0-d metrics as floats, tensors as they are.
"""

import argparse
import os
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "attend_infer_repeat_tpu")
for _name in BLOCKED:
    sys.modules[_name] = None           # any import of them raises

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_here, os.pardir, os.pardir))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from attend_infer_repeat_torch import configs  # noqa: E402


def config_from(d) -> configs.Config:
    return configs.Config(
        name=d["name"], model=configs.ModelConfig(**d["model"]),
        data=configs.DataConfig(**d["data"]),
        train=configs.TrainConfig(**d["train"]),
        prior=configs.PriorAnnealConfig(**d["prior"]))


def bank():
    from attend_infer_repeat_torch.data import load_digit_bank

    return load_digit_bank("auto", digit_size=(8, 8))[0]


def result(state, metrics):
    return {"step": state.step,
            "metrics": {k: v.tolist() for k, v in metrics.items()},
            "params": {k: v.clone()
                       for k, v in state.model.state_dict().items()}}


def case_mesh_basics(mesh, inp):
    from attend_infer_repeat_torch.parallel import (
        batch_sharding, constrain_batch, replicate, shard_batch)
    from attend_infer_repeat_torch.parallel.sharding import gather_batch

    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    rows = constrain_batch(x, mesh)
    tree = shard_batch(mesh, {"imgs": torch.zeros((8, 5, 5)),
                              "nums": torch.zeros((8,), dtype=torch.int32)})
    return {"size": mesh.size(), "names": list(mesh.mesh_dim_names),
            "batch_sharding": repr(batch_sharding(mesh, x.ndim)),
            "replicate": repr(replicate(mesh)), "rows": rows,
            "gathered": gather_batch(rows, mesh),
            "tree": {k: tuple(v.shape) for k, v in tree.items()}}


def case_mesh_step(mesh, inp):
    """The mesh step and the single-process step from the same state."""
    from attend_infer_repeat_torch.train import (
        create_train_state, make_train_step)

    cfg = config_from(inp["config"])
    out = {}
    for name, m in (("single", None), ("mesh", mesh)):
        state = create_train_state(cfg, device="cpu")
        state, metrics = make_train_step(cfg, state.model, digit_bank=bank(),
                                         mesh=m)(state)
        out[name] = result(state, metrics)
    return out


def case_scan_mesh(mesh, inp):
    """K mesh steps through the K-step chunk and one by one."""
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step, make_train_step)

    cfg, k = config_from(inp["config"]), inp["k"]
    state = create_train_state(cfg, device="cpu")
    state, chunk = make_scan_train_step(cfg, state.model, bank(), k,
                                        mesh=mesh)(state)
    seq = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, seq.model, digit_bank=bank(), mesh=mesh)
    rows = [step(seq)[1] for _ in range(k)]
    return {"scan": result(state, chunk),
            "seq": result(seq, {key: torch.stack([r[key] for r in rows])
                                for key in rows[0]})}


def case_shardmap_external(mesh, inp):
    """The external-batch shard-map step, and the plain step, on the
    injected batch (and, if given, the injected noise)."""
    from attend_infer_repeat_torch.parallel import make_shardmap_train_step
    from attend_infer_repeat_torch.train import (
        create_train_state, make_train_step)

    cfg = config_from(inp["config"])
    batch, noise = inp["batch"], inp.get("noise")
    out = {}
    for name in ("plain", "shardmap"):
        state = create_train_state(cfg, device="cpu")
        if "params" in inp:
            state.model.load_state_dict(inp["params"])
        if name == "plain":
            step = make_train_step(cfg, state.model)
        else:
            step = make_shardmap_train_step(cfg, state.model, bank(), mesh,
                                            external_batch=True)
        state, metrics = step(state, batch, noise=noise)
        out[name] = result(state, metrics)
    return out


def case_shardmap_per_rank(mesh, inp):
    """Two steps from one state give the same numbers; a second step
    moves on."""
    from attend_infer_repeat_torch.parallel import make_shardmap_train_step
    from attend_infer_repeat_torch.train import create_train_state

    cfg = config_from(inp["config"])
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, device="cpu")
        step = make_shardmap_train_step(cfg, state.model, bank(), mesh)
        state, m1 = step(state)
        first = result(state, m1)
        state, m2 = step(state)
        runs.append({"first": first, "second": result(state, m2)})
    return {"runs": runs}


def case_serving(mesh, inp):
    """Infer (in one pass and tiled) and generate, single-device and over
    the mesh, from generators seeded alike."""
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.models.air import AIRModel
    from attend_infer_repeat_torch.serving import (
        make_generate_fn, make_infer_fn)

    cfg = config_from(inp["config"])
    model = AIRModel(cfg.model, use_baseline=False, device="cpu", seed=0)
    imgs, _ = make_synth_fn(cfg.data, bank(), device="cpu")(
        16, torch.Generator().manual_seed(0))
    out = {}
    for tile in (None, 4):
        for name, m in (("single", None), ("mesh", mesh)):
            fn = make_infer_fn(cfg, model, tile=tile, mesh=m)
            out[f"infer/{tile}/{name}"] = fn(
                imgs, torch.Generator().manual_seed(3))
    for name, m in (("single", None), ("mesh", mesh)):
        out[f"generate/{name}"] = make_generate_fn(cfg, model, mesh=m)(
            16, torch.Generator().manual_seed(9))
    return out


def state_tensors(state, metrics):
    """Everything a step leaves: parameters, optimizer state, metrics."""
    return {"step": state.step,
            "counts": {g: st.count for g, st in state.opt_state.items()},
            "params": {k: v.clone()
                       for k, v in state.model.state_dict().items()},
            "opt": {g: [t.clone() for t in (*st.nu, *st.trace)]
                    for g, st in state.opt_state.items()},
            "metrics": dict(metrics)}


def entry_points(mesh, inp):
    """Every mesh entry point once (a step twice), from fresh states and
    generators seeded alike; with each one's graphs, by count."""
    from attend_infer_repeat_torch.data import make_synth_fn
    from attend_infer_repeat_torch.models.air import AIRModel
    from attend_infer_repeat_torch.parallel import make_shardmap_train_step
    from attend_infer_repeat_torch.serving import (
        make_generate_fn, make_infer_fn)
    from attend_infer_repeat_torch.train import (
        create_train_state, make_scan_train_step, make_train_step)

    cfg, k, batch = config_from(inp["config"]), inp["k"], inp["batch"]
    out, n_graphs = {}, {}

    def steps(name, make, *args):
        state = create_train_state(cfg, device="cpu")
        step = make(state)
        rows = [step(state, *args)[1] for _ in range(2)]
        out[name] = state_tensors(state, {key: torch.stack(
            [r[key] for r in rows]) for key in rows[0]})
        n_graphs[name] = len(step.graphs)

    steps("step", lambda s: make_train_step(cfg, s.model, digit_bank=bank(),
                                            mesh=mesh))
    steps("step_external_batch", lambda s: make_train_step(
        cfg, s.model, mesh=mesh), batch)
    steps("shardmap_per_rank", lambda s: make_shardmap_train_step(
        cfg, s.model, bank(), mesh))
    steps("shardmap_external", lambda s: make_shardmap_train_step(
        cfg, s.model, bank(), mesh, external_batch=True), batch)

    state = create_train_state(cfg, device="cpu")
    scan = make_scan_train_step(cfg, state.model, bank(), k, mesh=mesh)
    out["chunk"] = state_tensors(*scan(state))
    n_graphs["chunk"] = len(scan.graphs)

    model = AIRModel(cfg.model, use_baseline=False, device="cpu", seed=0)
    imgs, _ = make_synth_fn(cfg.data, bank(), device="cpu")(
        16, torch.Generator().manual_seed(0))
    for name, tile in (("infer_one_pass", None), ("infer_tiled", 4)):
        fn = make_infer_fn(cfg, model, tile=tile, mesh=mesh)
        g = torch.Generator().manual_seed(3)
        out[name] = {"out": fn(imgs, g), "generator": g.get_state()}
        n_graphs[name] = len(fn.graphs)
    fn = make_generate_fn(cfg, model, mesh=mesh)
    g = torch.Generator().manual_seed(9)
    out["generate"] = {"out": fn(16, g), "generator": g.get_state()}
    n_graphs["generate"] = len(fn.graphs)
    return out, n_graphs


def case_graphed(mesh, inp):
    """Every mesh entry point through its graphed path, with the capture
    stubbed out (``torch_uncaptured``), and through its eager path
    (``debug_mode``): each rank issues the collectives of the warm-up
    runs, the capture and the replays."""
    import pytest
    from torch_uncaptured import UncapturedGraph

    from attend_infer_repeat_torch.utils import debug_mode

    patch = pytest.MonkeyPatch()
    UncapturedGraph.install(patch)
    try:
        graphed, n_graphs = entry_points(mesh, inp)
        with debug_mode(nans=False):
            eager, _ = entry_points(mesh, inp)
    finally:
        patch.undo()
    return {"graphed": graphed, "eager": eager, "n_graphs": n_graphs}


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--case", required=True, choices=sorted(CASES))
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    from attend_infer_repeat_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(args.store,
                                                         args.world),
                            rank=args.rank, world_size=args.world)
    try:
        mesh = make_mesh()
        inp = torch.load(args.inputs, weights_only=False)
        out = CASES[args.case](mesh, inp)
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED
                  and sys.modules[m] is not None]
        out["jax_modules_loaded"] = loaded
        torch.save(out, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
