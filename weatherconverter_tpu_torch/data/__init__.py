"""Data: on-device augmentation (the diffusion subset of the JAX package's
data/transforms.py), the image datasets, and the Cityscapes label lookups."""
