"""guidance — see weatherconverter_tpu.guidance for the JAX counterpart."""
