"""compat — see weatherconverter_tpu.compat for the JAX counterpart."""
