"""Data parallelism over ``torch.distributed``: NCCL on the card, gloo on
the CPU.

The counterpart of the JAX package's ``parallel``: a 1-D device mesh over
the ``data`` axis, parameters and optimizer state replicated, the batch
split over the ranks.  ``make_train_step(..., mesh=)`` and
``make_scan_train_step(..., mesh=)`` keep GSPMD's meaning (the result
equals the single-device step); ``make_shardmap_train_step`` is the
explicit form, each rank on its own shard; ``make_infer_fn(..., mesh=)``
and ``make_generate_fn(..., mesh=)`` split a request and gather it.
"""

_EXPORTS = {
    "DATA_AXIS": "sharding",
    "batch_sharding": "sharding",
    "constrain_batch": "sharding",
    "make_mesh": "sharding",
    "replicate": "sharding",
    "shard_batch": "sharding",
    "make_shardmap_train_step": "shard_map_step",
}

__all__ = ["batch_sharding", "make_mesh", "replicate", "shard_batch",
           "make_shardmap_train_step"]


def __getattr__(name):
    # lazily: train.step imports parallel.sharding, and shard_map_step
    # imports train.step
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{submodule}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(_EXPORTS)
