"""Configuration dataclasses of the main path, without JAX.

Copies of ``tchvp_tpu/config.py``'s ``AutoEncoderConfig``, ``UNetConfig``,
``ResNetAEConfig``, ``TransformerConfig``, ``VideoModelConfig``,
``flagship_video_config``, ``SobelConfig``, ``FCTConfig``, ``DataConfig``,
``IngestConfig``, ``AugmentConfig`` and ``TrainConfig`` with identical field names and
defaults (``tests/test_torch_config.py`` and ``tests/test_torch_fct.py``
hold them equal), so a configuration means the same model and run in both
packages. Of the mesh-axis fields, ``TransformerConfig.seq_axis`` and
``ep_axis`` (sequence and expert parallelism), the ``tp_axis`` of
``ResNetAEConfig`` and ``TransformerConfig`` (tensor parallelism) and the
``sp_axis`` of ``ResNetAEConfig`` and ``FCTConfig`` (spatial partitioning)
act under a mesh carrying the axis; ``TrainConfig.mesh_axes``, which no
flow of the JAX package reads either, is kept for the equality alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    """Plain multi-scale-input conv AE. The default ``filters`` give a
    (B, 8, 8, 128) latent at 256^2; the notebook variant's
    ``(8, 16, 32, 64, 128, 512)`` gives (B, 4, 4, 512)."""

    filters: Sequence[int] = (8, 16, 32, 64, 128)
    out_channels: int = 3
    dropout_rate: float = 0.3

    @staticmethod
    def notebook_variant() -> "AutoEncoderConfig":
        return AutoEncoderConfig(filters=(8, 16, 32, 64, 128, 512))


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Classic 4-down/4-up UNet."""

    in_channels: int = 3
    out_channels: int = 1
    init_features: int = 32


@dataclasses.dataclass(frozen=True)
class ResNetAEConfig:
    """ResNet-bottleneck AE family (``Encoder32K`` / ``Decoder32K``).

    ``output_type`` switches the decoder head: "image" -> 3ch+ReLU,
    "mask" -> 1ch+sigmoid. ``token_latent`` reshapes the latent map to the
    (B, 8, H'*W') token sequence.
    """

    layers: Sequence[int] = (3, 4)
    stem_features: int = 64
    squeeze_features: Sequence[int] = (128, 64, 16, 8)
    output_type: str = "image"
    dropout_rate: float = 0.3
    token_latent: bool = False
    vae: bool = False
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Temporal transformer. ``relu_qkv``: ReLU on projected q/k/v;
    ``scale_out``: x sqrt(0.5) per layer; dropout is off in eval."""

    input_dim: int = 4096
    hidden_dim: int = 2048
    num_layers: int = 2
    num_heads: int = 8
    dropout_rate: float = 0.1
    relu_qkv: bool = True
    scale_out: bool = True
    attn_impl: str = "xla"  # "xla" | "flash" | "windowed" | "auto" | "ring"
    window_size: int = 0  # 0 = full attention; >0 = overlapping windows
    tp_axis: Optional[str] = None
    seq_axis: Optional[str] = None
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    router_top_k: int = 1
    ep_axis: Optional[str] = None


def flagship_video_config(
    image_size: int = 224,
    num_heads: int = 8,
    hidden_dim: int = 2048,
    num_layers: int = 2,
    attn_impl: str = "xla",
    window_size: int = 0,
    num_experts: int = 0,
    router_top_k: int = 1,
    ep_axis: Optional[str] = None,
    seq_axis: Optional[str] = None,
    tp_axis: Optional[str] = None,
    sp_axis: Optional[str] = None,
) -> "VideoModelConfig":
    """The flagship: per-frame CNN encoder -> temporal transformer ->
    decoder. The token embedding dim is the flattened latent map,
    (image_size/4)^2."""
    d = (image_size // 4) ** 2
    if d % num_heads:
        raise ValueError(f"latent dim {d} not divisible by {num_heads} heads")
    return VideoModelConfig(
        encoder=ResNetAEConfig(
            token_latent=True, tp_axis=tp_axis, sp_axis=sp_axis
        ),
        temporal=TransformerConfig(
            input_dim=d,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            attn_impl=attn_impl,
            window_size=window_size,
            num_experts=num_experts,
            router_top_k=router_top_k,
            ep_axis=ep_axis,
            seq_axis=seq_axis,
            tp_axis=tp_axis,
        )
    )


@dataclasses.dataclass(frozen=True)
class VideoModelConfig:
    """Flagship video pipeline: CNN encoder -> temporal transformer -> decoder."""

    encoder: ResNetAEConfig = dataclasses.field(
        default_factory=lambda: ResNetAEConfig(token_latent=True)
    )
    temporal: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig
    )
    output_type: str = "image"
    use_posenc: bool = True
    tokens_per_frame: int = 8  # latent channels become tokens


@dataclasses.dataclass(frozen=True)
class SobelConfig:
    """Sobel edge visualization (``ops/sobel.py``). ``edge_floor_rel``: a
    max gradient below this fraction of the input range counts as "no
    edges" and gives zeros; ``eps`` guards a zero input."""

    edge_floor_rel: float = 1e-5
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class FCTConfig:
    """Fully Convolutional Transformer (``models/fct.py``).

    ``stochastic_depth_rate``: the largest per-block drop-path rate of the
    linspace schedule (0.0: none). ``attn_impl``: "auto" (the flash kernels
    on CUDA, the dense core elsewhere), "xla", "flash" or "ring" (over
    ``seq_axis``); ``sp_axis``: the rows in blocks over that axis."""

    att_heads: int = 2
    filters: Sequence[int] = (8, 16, 32, 64, 128, 64, 32, 16, 8)
    stochastic_depth_rate: float = 0.0
    dropout_rate: float = 0.3
    out_channels: int = 1
    attn_impl: str = "auto"  # "auto" | "xla" | "flash" | "ring"
    seq_axis: Optional[str] = None
    sp_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """CSV-manifest data layer (``data/manifest.py``)."""

    train_csv: str = "Datasets/image2image/train.csv"
    val_csv: str = "Datasets/image2image/valid.csv"
    test_csv: str = "Datasets/image2image/test.csv"
    image_size: int = 256
    batch_size: int = 64
    training_type: str = "unsupervised"  # "supervised" | "unsupervised" | "sequential"
    clip_len: int = 8
    shuffle: bool = True
    drop_last: bool = True
    data_fraction: float = 1.0


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Host-ingest tuning of ``data/manifest.py``. The environment
    variables ``TCHVP_DECODE_THREADS`` and ``TCHVP_DECODE_CACHE_MB``
    override the first two."""

    decode_threads: Optional[int] = None  # None = min(8, cpu_count)
    cache_mb: int = 2048  # decoded-frame RAM cache budget
    prefetch_depth: int = 2  # batches the prefetch thread runs ahead


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Denoising-AE augmentations (``data/pipeline.py::augment_denoising``)
    and the beyond-reference suite (rot90, crop, jitter:
    ``augment_geometric``), which is off by default."""

    hflip_prob: float = 0.5
    noise_prob: float = 0.2
    noise_std: float = 0.05
    max_blackout_patches: int = 3
    blackout_size: int = 16
    test_blackout_size: int = 32
    rot90_prob: float = 0.0
    crop_prob: float = 0.0
    crop_frac: float = 0.875
    jitter_prob: float = 0.0
    jitter_strength: float = 0.2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training run settings (optimizer, loss, schedule, checkpoints)."""

    epochs: int = 250
    lr: float = 1e-3
    weight_decay: float = 0.01
    optimizer: str = "adamw"  # "adamw" | "adam" | "sgd" | "lion"
    batch_size: int = 64
    loss: str = "mixed"  # "mixed" | "dice" | "mse"
    mixed_alpha: float = 0.5
    mixed_beta: float = 0.5
    mixed_data_range: float = 1.0
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "runs"
    sample_dir: str = "saved_samples"
    model_name: str = "IMAGE2IMAGE"
    save_every: int = 5
    seed: int = 0
    mesh_axes: Tuple[str, ...] = ("data",)
    sync_batch_norm: bool = True
    dtype: str = "bfloat16"
    moe_aux_weight: float = 0.0
    schedule: Optional[str] = None  # None/"constant" | "cosine"
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_ratio: float = 0.0
    ema_decay: float = 0.0
    async_checkpoint: bool = False
    keep_checkpoints: int = 0
    device_prefetch: int = 0
