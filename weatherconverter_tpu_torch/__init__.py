"""WeatherConverter on PyTorch and CUDA: the port of `weatherconverter_tpu`
(JAX/Pallas on a TPU) to an NVIDIA H100.

The subpackages keep the JAX package's layout and module names, so each
module's counterpart is easy to find. Models are `nn.Module`s in NCHW; the
public attention and translation functions keep the JAX package's layouts
((B, H, N, D) attention, NHWC images). The JAX package stays the reference
this port is tested against; nothing here imports JAX.
"""

__version__ = "0.1.0"
