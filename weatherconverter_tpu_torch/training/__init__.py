"""training — see weatherconverter_tpu.training for the JAX counterpart."""
