"""metrics — see weatherconverter_tpu.metrics for the JAX counterpart."""
