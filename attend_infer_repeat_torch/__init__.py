"""attend_infer_repeat_torch: Attend-Infer-Repeat in PyTorch on CUDA.

The PyTorch counterpart of ``attend_infer_repeat_tpu``, module for module.
It imports neither JAX nor the JAX package.  The spatial transformer's
bilinear gather and its backward, the model's hand-written kernels, are
CUDA C++ for Hopper (``csrc/st_gather.cu``, ``csrc/st_gather_bwd.cu``),
built with ``nvcc`` at first use::

    import attend_infer_repeat_torch as air
    cfg = air.get_config("serving")
    model = air.AIRModel(cfg.model, use_baseline=False)      # on CUDA
    infer = air.make_infer_fn(cfg, model)
    out = infer(imgs)                                         # dict of tensors

    cfg = air.get_config("canonical_fast")
    state = air.create_train_state(cfg)                       # on CUDA
    bank, _ = air.load_digit_bank(cfg.data.source, cfg.data.digit_size)
    step = air.make_train_step(cfg, state.model, digit_bank=bank)
    state, metrics = step(state)                              # one update

    scan = air.make_scan_train_step(cfg, state.model, bank, 100)
    state, rows = scan(state)        # 100 updates: one CUDA graph, replayed

    state = air.train(cfg, workdir="runs/canonical_fast")     # the loop

or ``python -m attend_infer_repeat_torch.train --config canonical_fast``.
``parallel`` splits the steps and serving over the ranks of a
``torch.distributed`` mesh; ``utils`` has the profiler trace, the host
spans and the NaN trap.
Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (``resolve_device``).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Config": "configs",
    "get_config": "configs",
    "PRESETS": "configs",
    "AIRModel": "models",
    "AIRCell": "models",
    "AIROutputs": "models",
    "AIRStepOutput": "models",
    "SQAIRModel": "models",
    "SequenceConfig": "configs",
    "SpaceModel": "models",
    "SpaceConfig": "configs",
    "make_infer_fn": "serving",
    "make_generate_fn": "serving",
    "load_digit_bank": "data",
    "make_synth_fn": "data",
    "synthesize_batch": "data",
    "params_from_flax": "convert",
    "create_train_state": "train",
    "make_train_step": "train",
    "make_scan_train_step": "train",
    "make_eval_step": "train",
    "train": "train",
    "CheckpointManager": "train",
    "BestCheckpointTracker": "train",
    "restore_latest": "train",
    "evaluate": "eval",
    "MetricsLogger": "eval",
    "make_iwae_eval_step": "eval",
    "surrogate_loss": "models.estimator",
    "TrainState": "train",
    "count_confusion": "eval",
    "load_data": "data",
    "make_mesh": "parallel",
    "shard_batch": "parallel",
    "make_shardmap_train_step": "parallel",
    "debug_mode": "utils",
    "checkify_fn": "utils",
    "trace": "utils",
    "enable_compilation_cache": "utils",
}

__all__ = sorted(_EXPORTS) + ["__version__", "resolve_device"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means CUDA.  Raises when CUDA is asked for (or implied) and
    absent: the port never falls back to the CPU on its own.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{submodule}")
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
