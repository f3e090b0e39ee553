"""models — see weatherconverter_tpu.models for the JAX counterpart."""
