"""H100 micro-probes: each asks on the card the question that one of the JAX
package's `scripts/` probes asked on the TPU, through a hand-written CUDA
kernel beside its plain PyTorch version.

  micro_attn          K4  exp2 form of the flash forward against K1
  probe_int8_dot      K7  raw QK^T, int8 against bf16
  probe_dw3x3         K6  3x3 depthwise conv against cuDNN
  probe_dw9x9_floor   K5  FMA floor of a 9x9 depthwise conv against the SRGAN tail

and two quality checks, the port of scripts/int8_quality_check.py and the
legacy UNet's precision:

  int8_quality        K2 against K1 on the full-width guided chain
  legacy_precision    the legacy UNet's bf16 chain on the card against its f32 chain

Run one on a machine with a CUDA card:
    python -m weatherconverter_tpu_torch.probes.<name>
Each exits with code 2 when there is no card; none has a CPU mode.
"""
