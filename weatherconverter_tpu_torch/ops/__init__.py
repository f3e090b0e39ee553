"""ops — see weatherconverter_tpu.ops for the JAX counterpart."""
