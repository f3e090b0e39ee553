"""diffusion — see weatherconverter_tpu.diffusion for the JAX counterpart."""
