"""The port's `export-hlo` and its runtime (cli/commands.run_export_hlo,
serving/hlo_runtime.load_exported) and the kernels' custom ops, on the CPU.

The round trip: the CLI writes the program (`--attn bf16`, the tiny config
of tests/test_torch_cli.py, 3 steps, batch 2); a FRESH process that imports
no model code of the port loads it through `load_exported` and runs it on
JAX's weights (through compat/from_jax) and JAX's draws; its output equals
the live port program's bit for bit. The live program is held against JAX's
`export-hlo --attn bf16` function (fused=False; tests/test_hlo_runtime.py's
`fn`) at the chain tolerance of tests/test_torch_translate.py (1e-4).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_strict, seeded_leaves

from weatherconverter_tpu.core.config import load_translation_config as j_load_translation_config
from weatherconverter_tpu.diffusion.sampling import ddpm_sample as j_ddpm_sample
from weatherconverter_tpu.diffusion.schedule import make_schedule as j_make_schedule
from weatherconverter_tpu.guidance.translate import sample_with_sgg as j_sample_with_sgg
from weatherconverter_tpu.models.factory import make_seg_model as j_make_seg_model
from weatherconverter_tpu.models.srgan import Generator as JGenerator
from weatherconverter_tpu.models.unet import Unet as JUnet
from weatherconverter_tpu_torch.cli import commands as PC
from weatherconverter_tpu_torch.cli import main as PM
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.config import load_translation_config
from weatherconverter_tpu_torch.ops import attention as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B = 3, 2
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4
# tests/test_torch_cli.py's tiny translation config (DeepLabV3+/ResNet-18, 19 classes, a 2x SRGAN)
TINY_YAML = """
diffusion:
  model:
    im_size: 16
    down_channels: [8, 16, 24]
    mid_channels: [24, 24, 16]
    down_sample: [true, false]
    time_emb_dim: 16
    num_down_layers: 1
    num_mid_layers: 1
    num_up_layers: 1
    num_heads: 2
    attn_resolutions: [8]
  diffusion:
    num_timesteps: 20
seg:
  model: {name: deeplabv3plus_resnet18, num_classes: 19, output_stride: 16}
srgan: {in_channels: 3, num_channels: 8, num_blocks: 1, upscale_factor: 2}
guidance: {lambda: 10.0, num_steps: 3, mode: fixed}
"""

# the consumer: torch, the archive and the flat arguments; no model code of the port, no JAX
_CONSUMER = """
import sys
sys.path.insert(0, sys.argv[4])
import torch
torch.set_num_threads(1)
from weatherconverter_tpu_torch.serving import load_exported

call = load_exported(sys.argv[1])
args = torch.load(sys.argv[2])
torch.save(call(*args), sys.argv[3])
banned = [m for m in sys.modules if m.startswith(("weatherconverter_tpu_torch.models", "weatherconverter_tpu.", "jax"))]
assert not banned, banned
"""


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("export") / "t.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def _jax_models(cfg_path, program):
    """JAX's models of the exported function (fused=False) with seeded
    weights (numpy on JAX's parameter trees, `seeded_leaves`: no init
    compile), and the port's models holding the same weights."""
    jcfg = j_load_translation_config(cfg_path)
    cfg = load_translation_config(cfg_path)
    size = jcfg.diffusion.model.im_size
    hr = size * jcfg.srgan.upscale_factor
    key = jax.random.PRNGKey(11)

    def weights(model, *example, seed):
        return seeded_leaves(jax.eval_shape(lambda: model.init(key, *example)), seed)

    junet = JUnet(config=jcfg.diffusion.model, fused=False)
    jax_vars = {"unet": weights(junet, jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32), seed=1)["params"]}
    port = PC.inference_models(cfg, program, "bf16", device="cpu")
    load_strict(port["unet"], from_jax.unet_state_dict(jax_vars["unet"], cfg.diffusion.model))
    jmods = {"unet": junet}
    if program == "translate":
        jmods["seg"] = j_make_seg_model(jcfg.seg.model.name, jcfg.seg.model.num_classes, jcfg.seg.model.output_stride,
                                        train=False)
        jax_vars["seg"] = weights(jmods["seg"], jnp.zeros((1, hr, hr, 3)), seed=2)
        jmods["srgan"] = JGenerator(in_channels=jcfg.srgan.in_channels, num_channels=jcfg.srgan.num_channels,
                                    num_blocks=jcfg.srgan.num_blocks, upscale_factor=jcfg.srgan.upscale_factor)
        jax_vars["srgan"] = weights(jmods["srgan"], jnp.zeros((1, size, size, 3)), seed=3)
        load_strict(port["seg"], from_jax.deeplab_state_dict(jax_vars["seg"], cfg.seg.model.name))
        load_strict(port["srgan"], from_jax.srgan_generator_state_dict(jax_vars["srgan"], cfg.srgan.num_blocks))
    return jcfg, jmods, jax_vars, cfg, port


def _jax_run(jcfg, jmods, jax_vars, program, data, key):
    """JAX's export-hlo function (cli/commands.py run_export_hlo, as tests/test_hlo_runtime.py rebuilds it)."""
    d = jcfg.diffusion
    sched = j_make_schedule(d.diffusion.schedule, d.diffusion.num_timesteps, d.diffusion.beta_start,
                            d.diffusion.beta_end)
    unet = lambda x, t: jmods["unet"].apply({"params": jax_vars["unet"]}, x, t)  # noqa: E731
    if program == "sample":
        return np.asarray(jax.jit(lambda k: j_ddpm_sample(unet, sched, k, data["x_init"].shape, num_steps=STEPS))(key))
    g = jcfg.guidance

    def fn(inp, gt, k):
        return j_sample_with_sgg(unet, sched, lambda x: jmods["seg"].apply(jax_vars["seg"], x),
                                 lambda x: jmods["srgan"].apply(jax_vars["srgan"], x), inp, gt, k, lam=g.lambda_,
                                 num_steps=STEPS, num_classes=jcfg.seg.model.num_classes, mode=g.mode,
                                 start_t=STEPS - 1)

    return np.asarray(jax.jit(fn)(jnp.asarray(data["input"]), jnp.asarray(data["labels"]).astype(jnp.int32), key))


def _jax_draws(key, shape, program):
    """The draws the JAX function makes from `key`, in its split order: (x_init or
    noise0, z_steps)."""
    if program == "sample":
        key, first = jax.random.split(key)
    else:
        key, _tkey, first = jax.random.split(key, 3)
    zs = []
    for _ in range(STEPS):
        key, zkey = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(zkey, shape)))
    return np.asarray(jax.random.normal(first, shape)), np.stack(zs)


@pytest.mark.parametrize("program", ["translate", "sample"])
def test_export_roundtrip_bit_equal_in_a_fresh_process_and_live_program_matches_jax(cfg_path, tmp_path, program):
    out = str(tmp_path / f"{program}.pt2")
    assert PM.main(["export-hlo", "--config", cfg_path, "--program", program, "--steps", str(STEPS), "--batch",
                    str(B), "--out", out, "--device", "cpu"]) == 0
    jcfg, jmods, jax_vars, cfg, port = _jax_models(cfg_path, program)
    size = cfg.diffusion.model.im_size
    hr = size * cfg.srgan.upscale_factor
    key = jax.random.PRNGKey(7)
    first, z_steps = _jax_draws(key, (B, size, size, 3), program)
    rng = np.random.default_rng(5)
    if program == "sample":
        data = {"x_init": first, "z_steps": z_steps}
    else:
        data = {"input": (rng.standard_normal((B, size, size, 3)) * 0.2).astype(np.float32),
                "labels": rng.integers(0, cfg.seg.model.num_classes, (B, hr, hr)), "noise0": first,
                "z_steps": z_steps}
    args = PC.weight_arguments(port) + [torch.from_numpy(np.asarray(a)) for a in data.values()]
    spec = PC.program_arguments(cfg, program, STEPS, B, port)
    assert [(tuple(a.shape), a.dtype) for a in args] == [(s, d) for _, s, d in spec]
    live = PC.inference_program(cfg, program, STEPS, port, torch.device("cpu"))(*args)

    torch.save(args, tmp_path / "args.pt")
    r = subprocess.run([sys.executable, "-c", _CONSUMER, out, str(tmp_path / "args.pt"), str(tmp_path / "out.pt"),
                        REPO], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    served = torch.load(tmp_path / "out.pt")
    want = (B, hr, hr, 3) if program == "translate" else (B, size, size, 3)
    assert served.shape == live.shape == want and served.dtype == live.dtype == torch.float32
    assert torch.equal(served, live)

    ref = _jax_run(jcfg, jmods, jax_vars, program, data, key)
    np.testing.assert_allclose(live.numpy(), ref, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


def test_export_int8_needs_cuda(cfg_path, tmp_path):
    """JAX refuses its int8 export off its accelerator (cli/commands.py:555-563); the port refuses it off CUDA."""
    with pytest.raises(SystemExit, match="CUDA"):
        PM.main(["export-hlo", "--config", cfg_path, "--attn", "int8", "--out", str(tmp_path / "x.pt2"), "--device",
                 "cpu"])
    assert not (tmp_path / "x.pt2").exists()


def _op_cases():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 2, 128, 16), generator=g) for _ in range(4))
    o, l = A.flash_attention_plain(q, k, v, return_l=True)
    q8, k8, scales = A.quantize_qk_i8_plain(q, k, per_item=True)
    return [("flash_fwd", A._k1_op, (q, k, v, True)), ("flash_fwd_no_l", A._k1_op, (q, k, v, False)),
            ("flash_fwd_f32", A._k1_f32_op, (q, k, v, True)), ("flash_bwd", A._k3_op, (q, k, v, o, do, l)),
            ("flash_bwd_f32", A._k3_f32_op, (q, k, v, o, do, l)),
            ("quantize_qk_i8", A._quantize_op, (q.bfloat16(), k.bfloat16(), False)),
            ("quantize_qk_i8_per_item", A._quantize_op, (q.bfloat16(), k.bfloat16(), True)),
            ("flash_fwd_qk_i8", A._k2_op, (q8, k8, scales, v.bfloat16())),
            # f32 inputs: the quantizer in front of K2-f32, and K2-f32 (an f32 V), as an f32 program holds them
            ("quantize_qk_i8_f32", A._quantize_op, (q, k, False)),
            ("quantize_qk_i8_f32_per_item", A._quantize_op, (q, k, True)),
            ("flash_fwd_qk_i8_f32", A._k2_op, (q8, k8, scales, v))]


@pytest.mark.parametrize("case", range(11), ids=[c[0] for c in _op_cases()])
def test_kernel_custom_ops_pass_opcheck(case):
    """Each kernel's op (ops/attention.OPS): its schema, its fake
    implementation against the CPU one, its dispatch under autograd and
    under AOT tracing with dynamic shapes. K2 and its quantizer take f32 as
    one op each: the `_f32` cases name their inputs, not another op."""
    name, op, args = _op_cases()[case]
    qualname = name.removesuffix("_no_l").removesuffix("_per_item")
    if op in (A._quantize_op, A._k2_op):
        qualname = qualname.removesuffix("_f32")
    assert str(op._qualname) == f"{A.OPS}::{qualname}"
    torch.library.opcheck(op, args)


def test_public_functions_reach_the_ops_on_the_cpu():
    """The public wrappers run the ops' CPU implementations, the plain versions: the same numbers, no launch counted."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 1024, 16), generator=g) for _ in range(3))
    counts = (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches)
    assert torch.equal(A.flash_attention(q, k, v), A.flash_attention_plain(q, k, v))
    for per_item in (False, True):
        assert torch.equal(A.flash_attention_qk_i8(q, k, v, per_item=per_item),
                           A.flash_attention_qk_i8_plain(q, k, v, per_item=per_item))
    assert (A.flash_attention.launches, A.flash_attention_qk_i8.launches, A.quantize_qk_i8.launches) == counts
    gm = torch.fx.experimental.proxy_tensor.make_fx(lambda a, b, c: A.flash_attention_qk_i8(a, b, c, per_item=True),
                                                    tracing_mode="fake")(q, k, v)
    targets = {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    assert {f"{A.OPS}.quantize_qk_i8.default", f"{A.OPS}.flash_fwd_qk_i8.default"} <= targets
