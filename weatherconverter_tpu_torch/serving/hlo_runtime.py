"""Load an exported inference program and run it: no model code.

The consumer half of the CLI's `export-hlo` (cli/commands.run_export_hlo),
the counterpart of weatherconverter_tpu/serving/hlo_runtime.load_stablehlo.
A serving host loads the torch.export archive once and calls it like a
function, without this package's models, the config system or the seg and
SRGAN definitions. The program takes its flat arguments in the order
`cli/commands.program_arguments` documents and `<archive>.json` lists
(weights first, then the input, the labels and the chain's draws, which
JAX draws from a key: a traced program takes no torch.Generator). A
`--attn int8` archive holds K2 and its quantizer as custom ops; loading it
imports their registrations (`ops/attention`, which builds the kernels at
their first launch), and `core/precision` (the program computes in f32,
and on CUDA runs without TF32, as the live program does), and nothing else
of the package. Bit-exactness against
the live program is pinned by tests/test_torch_export.py (a fresh process,
CPU) and chip_smoke.py phase 21 (the card).
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import torch

from weatherconverter_tpu_torch.core.precision import f32_arithmetic


def load_exported(path: str, *, device: Optional[str] = None) -> Callable:
    """The program written by `export-hlo` at `path` as a callable over its
    flat arguments (tensors or arrays, moved to the program's device) that
    returns the output tensor. It runs on the device it was exported for,
    or on `device` (the archive moved there: a bf16 archive runs anywhere,
    an int8 one on CUDA only). `call.info` is the archive's description:
    program, steps, batch, attn, device, the arguments' names, shapes and
    dtypes, and the export's timings; `call.module` the loaded graph."""
    with open(path + ".json") as fh:
        info = json.load(fh)
    if info["attn"] == "int8":
        from weatherconverter_tpu_torch.ops import attention  # noqa: F401  registers the kernels' ops

    program = torch.export.load(path)
    target = torch.device(device or info["device"])
    if target.type != info["device"]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, target)
    module = program.module()

    def call(*args):
        if len(args) != len(info["args"]):
            raise ValueError(f"{path}: the program takes {len(info['args'])} arguments ({info['program']}: weights, "
                             f"then {', '.join(a[0] for a in info['args'][-4:])}), got {len(args)}")
        with torch.no_grad(), f32_arithmetic(target):
            return module(*(torch.as_tensor(a).to(target) for a in args))

    call.info, call.module = info, module
    return call
