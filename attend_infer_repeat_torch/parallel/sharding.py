"""The device mesh and the batch split over it (data parallelism).

AIR's parameters are small, so the layout is pure data parallelism:
parameters and optimizer state replicated on every rank, the batch (and
everything computed from it) split along axis 0 over the ``data`` axis of
a 1-D ``DeviceMesh``.  Where GSPMD inserts the collectives in the JAX
package, the port calls them: an all-reduce of the gradients and metrics,
an all-gather of a request's outputs.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None,
              device_type: Optional[str] = None,
              axis_name: str = DATA_AXIS):
    """1-D ``DeviceMesh`` over every rank of the default process group.

    One rank per card (``"cuda"``, NCCL) or per CPU process (``"cpu"``,
    gloo); ``device_type`` defaults to the group's backend.  With no
    process group yet, one of this process alone is made (world size 1,
    NCCL where there is a card), so a one-card run uses the same steps.
    ``n_devices``, if given, must be the world size.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans the whole process group: "
                         f"n_devices={n_devices}, world size {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(axis_name,))


def batch_sharding(mesh, ndim: int = 3, axis_name: str = DATA_AXIS):
    """The placement of a batch: axis 0 split over the mesh."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicate(mesh):
    """The placement of parameters, optimizer state and scalars."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def constrain_batch(x: torch.Tensor, mesh, axis_name: str = DATA_AXIS,
                    dim: int = 0) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (along ``dim``); ``x``
    itself when ``mesh`` is None."""
    if mesh is None:
        return x
    n, world = x.shape[dim], mesh.size()
    if n % world:
        raise ValueError(f"batch {n} does not divide over {world} ranks")
    rows = n // world
    return x.narrow(dim, mesh.get_local_rank() * rows, rows)


def shard_batch(mesh, tree, axis_name: str = DATA_AXIS):
    """This rank's rows of every tensor in a tree of batched tensors."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis_name) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis_name) for v in tree)
    return constrain_batch(torch.as_tensor(tree), mesh, axis_name)


def all_reduce_mean(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (one all-reduce of them all)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group())
    flat = flat / mesh.size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' rows of a batch, joined in rank order along axis 0."""
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group())
    return torch.cat(parts, 0)
