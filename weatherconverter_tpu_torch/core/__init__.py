"""core — see weatherconverter_tpu.core for the JAX counterpart."""
