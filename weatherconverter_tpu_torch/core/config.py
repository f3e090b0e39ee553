"""Configuration schema for DDPM training, segmentation training, Swift-SRGAN
training and guided translation.

A copy of weatherconverter_tpu/core/config.py, with the same field names and
defaults, so the same YAML files (configs/diffusion.yaml,
configs/segmentation.yaml, configs/translation*.yaml, an SRGAN training
YAML) load here. It is a copy because importing the JAX package's `core`
loads JAX (its core/__init__ imports core/rng.py).
"""

from __future__ import annotations

from typing import Any, Optional

import yaml
from pydantic import BaseModel, Field


class DiffusionDataConfig(BaseModel):
    root_dir: str = "data"
    acdc_dir: str = "ACDC"
    acdc_labels: str = "ACDC/gt"
    acdc_images: str = "ACDC/rgb_anon"
    bdd_dir: str = "BDD"
    dawn_dir: str = "DAWN"
    weather: list[str] = Field(default_factory=lambda: ["fog", "rain"])
    image_size: Any = 128  # int or [H, W]


class DiffusionProcessConfig(BaseModel):
    num_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    schedule: str = "linear"  # linear | cosine


class UnetModelConfig(BaseModel):
    """The DDPM UNet; the defaults are the production 128px ladder."""

    name: str = "ddpm"
    im_channels: int = 3
    im_size: int = 128
    down_channels: list[int] = Field(default_factory=lambda: [64, 128, 256, 512, 768])
    mid_channels: list[int] = Field(default_factory=lambda: [768, 768, 512])
    down_sample: list[bool] = Field(default_factory=lambda: [True, True, True, False])
    time_emb_dim: int = 128
    num_down_layers: int = 2
    num_mid_layers: int = 2
    num_up_layers: int = 2
    num_heads: int = 4
    attn_resolutions: list[int] = Field(default_factory=lambda: [8, 16, 32, 64])


class TrainingConfig(BaseModel):
    device: str = "auto"
    random_seed: int = 3455
    epochs: int = 200
    batch_size: int = 4
    num_workers: int = 0
    lr: float = 1e-4
    log_interval: int = 10
    save_interval: int = 10
    sample_interval: int = 1_000_000_000
    resume_training: bool = False
    resume_checkpoint: str = ""
    sample_size: int = 8
    num_grid_rows: int = 4
    dtype: str = "bfloat16"  # compute dtype of the model's forward and backward
    param_dtype: str = "float32"
    data_axis: str = "data"
    donate_state: bool = True
    ema_decay: float = 0.999
    # batch_size is per device and the global batch grows with the device
    # count; scale_lr_with_batch scales lr linearly with it
    scale_batch_to_mesh: bool = True
    scale_lr_with_batch: bool = False
    fsdp: bool = False
    accum_steps: int = 1  # microbatches per optimizer update


class FolderConfig(BaseModel):
    output: str = "outputs"
    weights: str = "weights"
    logs: str = "logs"
    checkpoints: str = "outputs/checkpoints"
    samples: str = "outputs/samples"


class DiffusionConfig(BaseModel):
    data: DiffusionDataConfig = Field(default_factory=DiffusionDataConfig)
    diffusion: DiffusionProcessConfig = Field(default_factory=DiffusionProcessConfig)
    model: UnetModelConfig = Field(default_factory=UnetModelConfig)
    training: TrainingConfig = Field(default_factory=TrainingConfig)
    folders: FolderConfig = Field(default_factory=FolderConfig)


class LossConfig(BaseModel):
    type: str = "CrossEntropyLoss"
    params: dict[str, Any] = Field(default_factory=lambda: {"ignore_index": 255, "reduction": "mean"})


class LRSchedulerConfig(BaseModel):
    type: str = "PolyLR"
    params: dict[str, Any] = Field(default_factory=lambda: {"power": 0.9})


class SegTrainingConfig(BaseModel):
    device: str = "auto"
    random_seed: int = 42
    epochs: int = 20
    batch_size: int = 8
    num_workers: int = 0
    log_interval: int = 10
    save_interval: int = 5
    resume_training: bool = False
    resume_checkpoint: str = ""
    loss_function: LossConfig = Field(default_factory=LossConfig)
    scheduler: LRSchedulerConfig = Field(default_factory=LRSchedulerConfig)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    data_axis: str = "data"
    scale_batch_to_mesh: bool = True
    scale_lr_with_batch: bool = False
    fsdp: bool = False
    accum_steps: int = 1


class JitterConfig(BaseModel):
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2


class RandomNoiseConfig(BaseModel):
    mean: float = 0.1
    std_range: list[float] = Field(default_factory=lambda: [0.0, 0.05])


class ClassWiseMaskingConfig(BaseModel):
    p: float = 0.1
    num_classes_to_keep: int = 1


class SegTransformConfig(BaseModel):
    resize_resolution: list[int] = Field(default_factory=lambda: [270, 480])
    target_resolution: list[int] = Field(default_factory=lambda: [256, 256])
    mean: list[float] = Field(default_factory=lambda: [0.485, 0.456, 0.406])
    std: list[float] = Field(default_factory=lambda: [0.229, 0.224, 0.225])
    horizontal_flip: float = 0.5
    # the geometric legs (None/0 = off, as in the shipped config); the port's
    # seg_train_augment refuses them until they are ported
    scale_range: list[float] | None = None
    rotation_degrees: float = 0.0
    hue: float = 0.0
    jitter: JitterConfig = Field(default_factory=JitterConfig)
    random_noise: RandomNoiseConfig = Field(default_factory=RandomNoiseConfig)
    class_wise_masking: ClassWiseMaskingConfig = Field(default_factory=ClassWiseMaskingConfig)


class SegDataConfig(BaseModel):
    root_dir: str = "data/ACDC"
    labels: str = "gt"
    images: str = "rgb_anon"
    train_split: str = "train"
    val_split: str = "val"
    weather: list[str] = Field(default_factory=lambda: ["fog", "rain"])
    transform: SegTransformConfig = Field(default_factory=SegTransformConfig)


class OptimizerConfig(BaseModel):
    """SGD; `layerwise_lr` gives the backbone's and the rest's ("classifier") learning rates."""

    type: str = "SGD"
    params: dict[str, Any] = Field(default_factory=lambda: {"lr": 1e-4, "momentum": 0.9, "weight_decay": 1e-4})
    layerwise_lr: dict[str, float] = Field(default_factory=lambda: {"backbone": 1e-5, "classifier": 1e-4})


class SegModelConfig(BaseModel):
    path: str = ""
    name: str = "deeplabv3plus_resnet101"
    num_classes: int = 19
    # ImageNet backbone init: a classification checkpoint's .pth path, or
    # 'imagenet'/'auto' for the file torch.hub would have cached (never fetched)
    pretrained_backbone: str = ""
    output_stride: int = 16
    bn_momentum: float = 0.01


class SegConfig(BaseModel):
    training: SegTrainingConfig = Field(default_factory=SegTrainingConfig)
    data: SegDataConfig = Field(default_factory=SegDataConfig)
    optimizer: OptimizerConfig = Field(default_factory=OptimizerConfig)
    model: SegModelConfig = Field(default_factory=SegModelConfig)
    folders: FolderConfig = Field(default_factory=FolderConfig)


class SRGANConfig(BaseModel):
    in_channels: int = 3
    num_channels: int = 64
    num_blocks: int = 16
    upscale_factor: int = 4
    checkpoint: str = ""


class SRGANTrainingConfig(TrainingConfig):
    """Swift-SRGAN training: `pretrain_epochs` of pixel-loss pretraining, then
    adversarial fine-tuning (the reference ships no SRGAN training)."""

    pretrain_epochs: int = 5
    g_lr: float = 1e-4
    d_lr: float = 1e-4
    pixel_loss: str = "l1"  # 'l1' | 'l2'
    adv_weight: float = 1e-3
    hr_crop: int = 96  # HR patch size; LR patch = hr_crop / upscale_factor


class SRGANTrainConfig(BaseModel):
    srgan: SRGANConfig = Field(default_factory=SRGANConfig)
    data: DiffusionDataConfig = Field(default_factory=DiffusionDataConfig)
    training: SRGANTrainingConfig = Field(default_factory=SRGANTrainingConfig)
    folders: FolderConfig = Field(default_factory=FolderConfig)


class GuidanceConfig(BaseModel):
    lambda_: float = Field(default=60.0, alias="lambda")
    num_steps: int = 500
    # 'reference' replicates the original code's overwrite of the guided x_t;
    # 'fixed' keeps the guided x_t
    mode: str = "fixed"
    model_config = {"populate_by_name": True}


class TranslationConfig(BaseModel):
    diffusion: DiffusionConfig = Field(default_factory=DiffusionConfig)
    seg: SegConfig = Field(default_factory=SegConfig)
    srgan: SRGANConfig = Field(default_factory=SRGANConfig)
    guidance: GuidanceConfig = Field(default_factory=GuidanceConfig)


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def load_diffusion_config(path: Optional[str] = None, **overrides) -> DiffusionConfig:
    """Load a diffusion config YAML (configs/diffusion.yaml's schema)."""
    data = load_yaml(path) if path else {}
    return DiffusionConfig(**_deep_update(data, overrides))


def load_seg_config(path: Optional[str] = None, **overrides) -> SegConfig:
    """Load a segmentation config YAML (configs/segmentation.yaml's schema)."""
    data = load_yaml(path) if path else {}
    return SegConfig(**_deep_update(data, overrides))


def load_srgan_train_config(path: Optional[str] = None, **overrides) -> SRGANTrainConfig:
    """Load a Swift-SRGAN training config YAML."""
    data = load_yaml(path) if path else {}
    return SRGANTrainConfig(**_deep_update(data, overrides))


def load_translation_config(path: Optional[str] = None, **overrides) -> TranslationConfig:
    data = load_yaml(path) if path else {}
    return TranslationConfig(**_deep_update(data, overrides))


def _deep_update(base: dict, upd: dict) -> dict:
    out = dict(base)
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def resolve_device_count() -> int:
    """Number of local CUDA cards visible to this process (JAX's local device
    count); 0 without one."""
    import torch

    return torch.cuda.device_count()
