"""Configuration dataclasses and the named presets.

The port's own copy of the configuration surface: the same four
dataclasses, the same fields and the same preset values as the JAX
package, so a preset names one model whichever package runs it
(``tests/test_torch_configs.py`` holds the two equal).

``ModelConfig.st_method`` and ``ModelConfig.st_block_b`` stay as fields so
that the presets compare equal, but the port's spatial transformer ignores
them: on a CUDA tensor it always launches the hand-written gather kernel
(``ops/st_kernel.py``), on a CPU tensor it always runs the plain einsum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture + generative-model hyperparameters for AIR."""

    img_size: Tuple[int, int] = (50, 50)
    glimpse_size: Tuple[int, int] = (20, 20)
    n_what: int = 50                      # appearance latent dim
    max_steps: int = 3                    # object steps

    # Network widths
    rnn_hidden: int = 256
    encoder_hidden: Tuple[int, ...] = (256,)
    # Optional stride-2 conv stem before the encoder MLP (no preset sets
    # it; ``models/modules.py`` builds it as flax does).
    encoder_conv: Tuple[int, ...] = ()
    glimpse_encoder_hidden: Tuple[int, ...] = (256,)
    decoder_hidden: Tuple[int, ...] = (256,)
    transform_hidden: Tuple[int, ...] = (256,)
    steps_hidden: Tuple[int, ...] = (128,)
    baseline_hidden: Tuple[int, ...] = (256, 256)

    # Gaussian-head parameterization: softplus(raw + offset) + min_scale
    scale_offset: float = -2.0
    min_scale: float = 1e-4

    # z_where prior N(loc, scale²) per (sx, sy, tx, ty).
    where_prior_loc: Tuple[float, ...] = (0.32, 0.32, 0.0, 0.0)
    where_prior_scale: Tuple[float, ...] = (0.05, 0.05, 1.0, 1.0)

    # z_where = (s, tx, ty) with sy = sx.
    isotropic_scale: bool = False
    # Hard cap on the attention-window scale where z_where drives the
    # spatial transformer (a true clip; the posterior and its KL stay on
    # the raw Gaussian).  None = unconstrained.
    max_scale: Optional[float] = None
    # Training step at which ``max_scale`` engages (training only).
    max_scale_from_step: int = 0

    # Initial presence-logit bias (explore first).
    steps_bias: float = 2.0
    explore_eps: Optional[float] = None   # presence-prob floor

    # Likelihood
    output_std: float = 0.3
    output_multiplier: float = 1.0

    # Each inference step encodes x − canvas-so-far (explain-away).
    residual_encoding: bool = True

    # Kept for equality with the JAX presets; ignored by the port.
    st_method: str = "xla"
    st_block_b: int = 8

    # Computation dtype for matmuls ("float32" or "bfloat16"); params stay
    # float32 either way.
    dtype: str = "float32"
    # Decoder (generative-path) dtype override; None follows ``dtype``.
    decoder_dtype: Optional[str] = None

    # Training-only memory knobs (rematerialization); serving ignores them.
    remat: bool = False
    # Rebuild the likelihood canvas outside the step loop from the
    # per-step glimpses; the carried canvas is then conditioning only.
    canvas_rebuild: bool = False
    # Storage dtype for the carried canvas (None = float32).
    canvas_carry_dtype: Optional[str] = None
    remat_policy: str = "full"


@dataclasses.dataclass(frozen=True)
class PriorAnnealConfig:
    """Anneal of the geometric prior's step-success probability."""

    init_success_prob: float = 1.0 - 1e-7
    final_success_prob: float = 1e-5
    anneal_start: int = 1_000
    anneal_steps: int = 100_000
    schedule: str = "exp"                 # "exp" | "linear"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop settings."""

    batch_size: int = 64
    learning_rate: float = 1e-5
    lr_decay_steps: Optional[int] = None
    lr_end_factor: float = 0.1
    momentum: float = 0.9
    baseline_learning_rate: float = 1e-4
    l2_weight: float = 0.0
    grad_clip_norm: Optional[float] = None
    n_iters: int = 300_000
    use_baseline: bool = True
    seed: int = 0

    kl_warmup_steps: int = 0

    # "elbo" (NVIL/REINFORCE surrogate) or "iwae" (VIMCO).
    objective: str = "elbo"
    iwae_particles: int = 5

    # Early-basin detect-and-restart (0 disables).
    basin_detect_step: int = 0
    basin_accuracy_threshold: float = 0.95
    basin_max_restarts: int = 5

    advantage_norm: bool = False
    # Train steps per host dispatch.
    scan_steps: int = 1
    iwae_eval_particles: int = 0
    log_grad_norms: bool = False
    best_metric: str = "count_accuracy_mode"

    log_every: int = 1_000
    fig_every: int = 10_000
    save_every: int = 10_000
    eval_batches: int = 8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Multi-digit canvas synthesis settings."""

    canvas_size: Tuple[int, int] = (50, 50)
    digit_size: Tuple[int, int] = (16, 16)
    min_digits: int = 0
    max_digits: int = 2
    scale_range: Tuple[float, float] = (1.0, 1.0)
    # "grid": distinct grid cells (disjoint boxes); "uniform": uniform
    # in-bounds positions with soft overlap rejection.
    placement: str = "grid"
    overlap_iou_max: float = 0.25
    place_attempts: int = 5
    # Fraction of a grid cell kept free at its boundary.
    cell_margin: float = 0.12
    n_train: int = 60_000
    n_eval: int = 10_000
    source: str = "auto"   # "auto" | "sklearn" | "mnist:<path>"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    prior: PriorAnnealConfig = PriorAnnealConfig()
    train: TrainConfig = TrainConfig()
    data: DataConfig = DataConfig()
    name: str = "canonical"


def _preset(name, **kw) -> Config:
    return Config(name=name, **kw)


# Model switches shared by the bf16 50×50 presets: isotropic windows, the
# bf16 compute mix with an f32 decoder, and a bf16 canvas carry.
_BF16_MODEL = dict(explore_eps=0.05, output_std=0.15,
                   where_prior_scale=(0.03, 0.03, 1.0, 1.0),
                   isotropic_scale=True,
                   dtype="bfloat16", decoder_dtype="float32",
                   canvas_carry_dtype="bfloat16",
                   remat=True, remat_policy="save_st")

# The batch-1024 training recipe shared by the bf16 50×50 presets.
_FAST_TRAIN = dict(batch_size=1024, learning_rate=1e-4,
                   lr_decay_steps=150_000,
                   baseline_learning_rate=1e-3,
                   grad_clip_norm=100.0, kl_warmup_steps=15_000,
                   n_iters=150_000, log_every=500,
                   fig_every=5_000, save_every=5_000,
                   scan_steps=100,
                   basin_detect_step=10_000,
                   basin_accuracy_threshold=0.95,
                   basin_max_restarts=5)

_FAST_PRIOR = PriorAnnealConfig(anneal_start=2_000, anneal_steps=40_000)


#: The named presets, equal field for field to the JAX package's.
PRESETS = {
    # One digit per image, one step: a one-glimpse VAE.
    "single_digit": _preset(
        "single_digit",
        model=ModelConfig(max_steps=1, explore_eps=0.05, output_std=0.15,
                          where_prior_scale=(0.03, 0.03, 1.0, 1.0),
                          isotropic_scale=True),
        data=DataConfig(min_digits=1, max_digits=1),
        train=TrainConfig(batch_size=1024, learning_rate=1e-4,
                          baseline_learning_rate=1e-3,
                          grad_clip_norm=100.0, kl_warmup_steps=10_000,
                          n_iters=50_000, log_every=500,
                          fig_every=5_000, save_every=5_000,
                          scan_steps=20),
        prior=PriorAnnealConfig(final_success_prob=0.5,
                                anneal_start=1_000, anneal_steps=10_000),
    ),
    # The paper's setup: 0–2 digits, 50×50, 3 steps, batch 64.
    "canonical": _preset(
        "canonical",
        model=ModelConfig(explore_eps=0.05),
        train=TrainConfig(scan_steps=100)),
    # Same model and task at batch 1024, with a window cap of 0.45.
    "canonical_fast": _preset(
        "canonical_fast",
        model=ModelConfig(max_scale=0.45, **_BF16_MODEL),
        train=TrainConfig(**_FAST_TRAIN),
        prior=_FAST_PRIOR,
    ),
    # Uniform placement with overlap, 20 px digits.
    "canonical_uniform": _preset(
        "canonical_uniform",
        model=ModelConfig(where_prior_loc=(0.4, 0.4, 0.0, 0.0),
                          max_scale=0.55, **_BF16_MODEL),
        data=DataConfig(digit_size=(20, 20), placement="uniform"),
        train=TrainConfig(**_FAST_TRAIN),
        prior=_FAST_PRIOR,
    ),
    # 0–5 digits on 100×100, 5 steps, f32, two-phase window cap.
    "crowded": _preset(
        "crowded",
        model=ModelConfig(img_size=(100, 100), max_steps=5,
                          explore_eps=0.05, output_std=0.15,
                          where_prior_scale=(0.03, 0.03, 1.0, 1.0),
                          where_prior_loc=(0.16, 0.16, 0.0, 0.0),
                          isotropic_scale=True,
                          max_scale=0.30, max_scale_from_step=30_000),
        data=DataConfig(canvas_size=(100, 100), min_digits=0, max_digits=5),
        train=TrainConfig(batch_size=1024, learning_rate=1.4e-4,
                          baseline_learning_rate=1e-3,
                          grad_clip_norm=100.0, kl_warmup_steps=15_000,
                          n_iters=150_000, log_every=500,
                          fig_every=5_000, save_every=5_000,
                          scan_steps=50),
        prior=PriorAnnealConfig(anneal_start=2_000, anneal_steps=100_000),
    ),
    # ~28 px rescaled digits, uniform placement (overlap unavoidable).
    "canonical_uniform28": _preset(
        "canonical_uniform28",
        model=ModelConfig(n_what=20,
                          where_prior_loc=(0.48, 0.48, 0.0, 0.0),
                          max_scale=0.62, **_BF16_MODEL),
        data=DataConfig(digit_size=(28, 28), scale_range=(0.7, 1.0),
                        placement="uniform"),
        train=TrainConfig(**dict(_FAST_TRAIN, lr_decay_steps=60_000)),
        prior=PriorAnnealConfig(anneal_start=2_000, anneal_steps=40_000,
                                final_success_prob=1e-3),
    ),
    # canonical_fast with the k=5 importance-weighted bound logged.
    "iwae": _preset(
        "iwae",
        model=ModelConfig(max_scale=0.45, **_BF16_MODEL),
        train=TrainConfig(iwae_eval_particles=5, **_FAST_TRAIN),
        prior=_FAST_PRIOR,
    ),
    # The k=5 bound as the training objective (VIMCO, no NVIL baseline).
    "iwae_trained": _preset(
        "iwae_trained",
        model=ModelConfig(max_scale=0.45, **_BF16_MODEL),
        train=TrainConfig(objective="iwae", iwae_particles=5,
                          use_baseline=False, iwae_eval_particles=5,
                          **_FAST_TRAIN),
        prior=_FAST_PRIOR,
    ),
    # NVIL-baseline ablation: f32, no scan, no remat.
    "no_nvil": _preset(
        "no_nvil",
        model=ModelConfig(explore_eps=0.05, output_std=0.15,
                          where_prior_scale=(0.03, 0.03, 1.0, 1.0),
                          isotropic_scale=True, max_scale=0.45),
        train=TrainConfig(batch_size=1024, learning_rate=1e-4,
                          baseline_learning_rate=1e-3,
                          grad_clip_norm=100.0, kl_warmup_steps=15_000,
                          n_iters=120_000, log_every=500,
                          fig_every=5_000, save_every=5_000,
                          use_baseline=False),
        prior=PriorAnnealConfig(anneal_start=2_000, anneal_steps=40_000),
    ),
    # Batch-8192 amortized inference/generation serving.
    "serving": _preset(
        "serving",
        train=TrainConfig(batch_size=8192),
    ),
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
