"""backbones — see weatherconverter_tpu.models.backbones for the JAX counterpart."""
