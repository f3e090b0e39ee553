"""Serving: the micro-batched HTTP server for translation and sampling, and
the runtime of exported programs (`load_exported`)."""

from weatherconverter_tpu_torch.serving.batcher import MicroBatcher
from weatherconverter_tpu_torch.serving.hlo_runtime import load_exported
from weatherconverter_tpu_torch.serving.server import TranslationService, serve

__all__ = ["MicroBatcher", "TranslationService", "load_exported", "serve"]
