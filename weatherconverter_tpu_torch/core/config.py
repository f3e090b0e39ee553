"""Configuration schema for guided translation (the sections the port uses).

A copy of the translation part of weatherconverter_tpu/core/config.py, with
the same field names and defaults, so the same YAML files
(configs/translation*.yaml) load here. It is a copy because importing the
JAX package's `core` loads JAX (its core/__init__ imports core/rng.py).

Sections the slice does not use (data, training, folders, the seg
transform/optimizer) are left out; pydantic ignores their keys in a YAML
file.
"""

from __future__ import annotations

from typing import Optional

import yaml
from pydantic import BaseModel, Field


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


class DiffusionConfig(BaseModel):
    diffusion: DiffusionProcessConfig = Field(default_factory=DiffusionProcessConfig)
    model: UnetModelConfig = Field(default_factory=UnetModelConfig)


class SegModelConfig(BaseModel):
    path: str = ""
    name: str = "deeplabv3plus_resnet101"
    num_classes: int = 19
    pretrained_backbone: str = ""
    output_stride: int = 16
    bn_momentum: float = 0.01


class SegConfig(BaseModel):
    model: SegModelConfig = Field(default_factory=SegModelConfig)


class SRGANConfig(BaseModel):
    in_channels: int = 3
    num_channels: int = 64
    num_blocks: int = 16
    upscale_factor: int = 4
    checkpoint: str = ""


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


def load_translation_config(path: Optional[str] = None, **overrides) -> TranslationConfig:
    data = {}
    if path:
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
    return TranslationConfig(**_deep_update(data, overrides))


def _deep_update(base: dict, upd: dict) -> dict:
    out = dict(base)
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out
