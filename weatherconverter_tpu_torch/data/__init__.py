"""Data: on-device augmentation (data/transforms.py), the image datasets, the
prefetching loader in JAX's index order (data/loader.py), the native batch
decoder's binding (data/native.py), and the Cityscapes label lookups."""
