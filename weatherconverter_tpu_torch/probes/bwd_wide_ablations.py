"""K3 at D = 192 (csrc/flash_bwd.cu's two-consumer passes) and the Q/K
quantizer (csrc/quantize_i8.cu's one cooperative launch) beside their
ablations, in one process on one card.

    python -m weatherconverter_tpu_torch.probes.bwd_wide_ablations

Each ablation undoes one choice: a copy of csrc/ with that edit (the anchor
text must be found) is built into a library of its own with nvcc
(flash_bwd.cu and quantize_i8.cu, all builds at once), and K3
(`wc_flash_bwd`) at (8, 4, 1024, 192) in bf16, and the quantizer
(`wc_quantize_qk_i8`) at QUANT_SHAPES in bf16 and f32 (one scale), are timed
with `common.time_ms` beside the shipped kernels, in two rounds. Each line
gives the times, whether the outputs equal the shipped kernels' bit for
bit, and K3's largest max|err|/max|ref| against the plain version; and
ptxas's register and spill lines of each build's changed kernels. The
ablations:

  dq_one_warpgroup  pass 1 at D = 192 on the one-warpgroup kernel (64 query
                    rows a block, 32-key score tiles), pass 2 as shipped
  one_warpgroup     both passes on one warpgroup, pass 2 as a dV launch and
                    a dK launch: the design the two-consumer passes replaced
  dkv_three_stages  pass 2's Q/dO ring three deep (232 KB of shared memory)
  quant_reread      the quantizer keeps nothing on chip: pass 2 reads every
                    chunk again (from L2 where the tensors fit)
  quant_fdiv        every element divided by __fdiv_rn and converted by
                    __float2int_rn (the arithmetic this one replaced)
  quant_no_sync     the grid-wide barrier taken out (wrong outputs): what
                    the barrier costs
  quant_pass1_only  the kernel ends at the barrier (no output): the launch,
                    pass 1 and the barrier alone
  quant_launch_only the kernel returns at once: the cooperative launch alone
  quant_store_only  pass 2 stores each element's low byte, no arithmetic
                    (wrong outputs): what the arithmetic costs
  quant_no_store    pass 2 computes and stores nothing (wrong outputs): what
                    the stores cost
  quant_stcs        the int8 stores evict-first (__stcs)
  quant_aligned     each block's range starts on a multiple of 32 chunks, so
                    a warp's stores cover whole 32-byte sectors
  quant_one_block   one block of 768 threads an SM (132 blocks, 220 KB of
                    shared memory each) in place of two of 384

`build(names)` gives the libraries alone (tests/test_torch_kernels.py holds
the shipped K3 bit-equal to `one_warpgroup`'s). Exit 2 without a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from weatherconverter_tpu_torch.ops import attention as A
from weatherconverter_tpu_torch.ops import cuda_build
from weatherconverter_tpu_torch.probes import common

SHAPE = (8, 4, 1024, 192)
QUANT_SHAPES = [(8, 4, 4096, 64), (8, 4, 1024, 128), (8, 4, 1024, 32), (8, 4, 4096, 16), (8, 4, 1024, 192)]
BWD, QUANT = "flash_bwd.cu", "quantize_i8.cu"
_DKV = "launch_dkv<T, D, {}>(q_, k_, v_, do_, linv, dvec, dk_, dv_, grid, n, scale, scale_log2, stream);"
_SPLIT_PASS2 = ("    if constexpr (D == 192) {  // pass 2 as a dV launch and a dK launch\n"
                f"      err = {_DKV.format(1)}\n"
                "      if (err != cudaSuccess) return err;\n"
                f"      return {_DKV.format(2)}\n"
                "    } else {\n"
                f"      return {_DKV.format(3)}\n"
                "    }")
_STORE8 = "    *reinterpret_cast<uint2*>(out) = make_uint2("  # a 16-bit chunk's int8 store
_RANGE = "(unsigned long long)w.cps * j / w.bps);"
ABLATIONS = {
    "dq_one_warpgroup": {BWD: [("launch_dq_wide<T>(q_,", "launch_dq<T, 192>(q_,")]},
    "one_warpgroup": {BWD: [("  if constexpr (D == 192) {\n", "  if constexpr (false) {\n"),
                            ("    return " + _DKV.format(3), _SPLIT_PASS2)]},
    "dkv_three_stages": {BWD: [("constexpr int kWideDkvStages = 2;", "constexpr int kWideDkvStages = 3;")]},
    "quant_reread": {QUANT: [("constexpr int kKeepRegs = ", "constexpr int kKeepRegs = 0 * "),
                             ("constexpr int kKeepSmemBytes = ", "constexpr int kKeepSmemBytes = 0 * ")]},
    "quant_fdiv": {QUANT: [("  if (near) {", "  if (true) {")]},
    "quant_no_sync": {QUANT: [("  cooperative_groups::this_grid().sync();", "")]},
    "quant_pass1_only": {QUANT: [("  cooperative_groups::this_grid().sync();",
                                  "  cooperative_groups::this_grid().sync();\n  return;")]},
    "quant_launch_only": {QUANT: [("  const int virt = 2 * w.scales * w.bps;\n",
                                   "  const int virt = 2 * w.scales * w.bps;\n  if (virt > 0) return;\n")]},
    "quant_store_only": {QUANT: [("  bool near = false;\n",
                                  "  bool near = false;\n#pragma unroll\n"
                                  "  for (int i = 0; i < kN; ++i) r[i] = __float_as_uint(x[i]);\n  return;\n")]},
    "quant_no_store": {QUANT: [(_STORE8, "    if (scale < 0.f) " + _STORE8.lstrip())]},
    "quant_stcs": {QUANT: [(_STORE8, "    __stcs(reinterpret_cast<uint2*>(out), make_uint2("),
                           ("pack_i8(r[4], r[5], r[6], r[7]));", "pack_i8(r[4], r[5], r[6], r[7])));"),
                           ("    *reinterpret_cast<uint32_t*>(out) = pack_i8(r[0], r[1], r[2], r[3]);",
                            "    __stcs(reinterpret_cast<unsigned int*>(out), pack_i8(r[0], r[1], r[2], r[3]));")]},
    "quant_aligned": {QUANT: [(_RANGE, "(j == w.bps ? w.cps : (unsigned long long)w.cps * j / w.bps / 32 * 32));")]},
    "quant_one_block": {QUANT: [("constexpr int kThreads = 384;", "constexpr int kThreads = 768;"),
                                ("constexpr int kBlocksPerSm = 2;", "constexpr int kBlocksPerSm = 1;"),
                                ("constexpr int kKeepSmemBytes = 110 * 1024;",
                                 "constexpr int kKeepSmemBytes = 220 * 1024;")]},
}


def _start_build(work: str, name: str, edits: dict) -> subprocess.Popen:
    src = os.path.join(work, name)
    shutil.copytree(cuda_build.CSRC_DIR, src)
    for file, pairs in edits.items():
        path = os.path.join(src, file)
        with open(path) as fh:
            text = fh.read()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"ablation {name}: {file} no longer holds {old!r}")
            text = text.replace(old, new, 1)
        with open(path, "w") as fh:
            fh.write(text)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", os.path.join(src, "lib.so"),
           *(os.path.join(src, f) for f in (BWD, QUANT))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names, work: str) -> dict:
    """{name: (ctypes library, ptxas lines)} of the ablations `names`, built at once under `work`."""
    procs = {name: _start_build(work, name, ABLATIONS[name]) for name in names}
    shipped = cuda_build.library()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        for fn in ("wc_flash_bwd", "wc_quantize_qk_i8"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, _ptxas_lines(log))
    return libs


def _ptxas_lines(log: str) -> str:
    """Registers and spills of the D = 192 backward kernels and the quantizer, bf16 and f32 alone."""
    lines = log.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" not in ln:
            continue
        mangled = ln.split("'")[1]
        wanted = ("quantize_qk_kernel" in mangled and ("13__nv_bfloat16" in mangled or "IfE" in mangled)) or (
            "flash_bwd" in mangled and "13__nv_bfloat16" in mangled and ("wide" in mangled or "Li192E" in mangled))
        if wanted:
            used = next((x for x in lines[i:i + 6] if "Used" in x and "registers" in x), "")
            spill = next((x for x in lines[i:i + 6] if "spill stores" in x), "")
            keep.append(f"{mangled}: {used.strip()} {spill.strip()}")
    return "; ".join(keep)


def k3_call(lib, args):
    """dq, dk, dv of `lib`'s wc_flash_bwd on (q, k, v, o, dO, l), contiguous bf16/f16 (B, H, N, D)."""
    q, k, v, o, do, l = args
    b, h, n, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((2, b * h, n), device=q.device, dtype=torch.float32)
    err = lib.wc_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), l.data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(), b * h, n, d,
                           int(q.dtype == torch.float16), d**-0.5, torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch("K3", err)
    return dq, dk, dv


def quant_call(lib, q, k):
    """q8, k8, qk_scale of `lib`'s wc_quantize_qk_i8 on contiguous q and k, one scale."""
    b, h, n, d = q.shape
    strides = (ctypes.c_longlong * 3)(*q.stride()[:3])
    slots = torch.empty(4096, device=q.device, dtype=torch.int32)
    q8, k8 = (torch.empty(q.shape, device=q.device, dtype=torch.int8) for _ in range(2))
    qk_scale = torch.empty(1, device=q.device, dtype=torch.float32)
    err = lib.wc_quantize_qk_i8(q.data_ptr(), k.data_ptr(), strides, strides, b, h, n, d, A._DTYPE_CODES[q.dtype], 1,
                                slots.data_ptr(), 4096, q8.data_ptr(), k8.data_ptr(), qk_scale.data_ptr(), d**0.5,
                                torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch("quantize_qk_i8", err)
    return q8, k8, qk_scale


def main(argv=None) -> int:
    if not common.require_cuda("bwd_wide_ablations"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    work = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR if os.path.isdir(cuda_build.BUILD_DIR) else None)
    try:
        built = build(list(ABLATIONS), work)
        libs = {"shipped": cuda_build.library()}
        for name, (lib, ptxas) in built.items():
            common.log(f"{name}: ptxas: {ptxas}")
            libs[name] = lib
        run(libs, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def _line(name, what, runs, shipped_runs, same, extra="") -> str:
    return (f"{name} {what}: {sum(runs) / len(runs):.4f} ms (runs {', '.join(f'{t:.4f}' for t in runs)}; shipped/this "
            f"{sum(shipped_runs) / sum(runs):.3f}x), equal to shipped {same}{extra}")


def run(libs: dict, card: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, l = A.flash_attention_plain(q, k, v, return_l=True)
    args = (q, k, v, o, do, l)
    ref = A.flash_attention_bwd_plain(*args)
    ms = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            ms[name].append(common.time_ms(lambda: k3_call(lib, args), reps=20))
    shipped = k3_call(libs["shipped"], args)
    for name, lib in libs.items():
        got = k3_call(lib, args)
        same = all(torch.equal(a, b) for a, b in zip(got, shipped))
        rel = max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item() for g, r in zip(got, ref))
        common.log(_line(name, f"K3 {SHAPE}", ms[name], ms["shipped"], same, f", max|err|/max|ref| {rel:.2e}")
                   + f" [{card}]")
    common.log(f"sdpa backward alone {common.sdpa_ms(q, k, v, do):.4f} ms [{card}]")
    del q, k, v, do, o, l, args, ref, shipped

    for shape in QUANT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            qq, kk = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
            qms, failed = {name: [] for name in libs}, {}
            for _ in range(2):
                for name, lib in libs.items():
                    try:
                        qms[name].append(common.time_ms(lambda: quant_call(lib, qq, kk), reps=20))
                    except RuntimeError as exc:  # said, and the other builds go on
                        failed[name] = str(exc)
            shipped = quant_call(libs["shipped"], qq, kk)
            bound = common.quantizer_roofline(common.peaks(card), shape, elem_bytes=qq.element_size())
            for name, lib in libs.items():
                if name in failed:
                    common.log(f"{name} quantizer {shape}: {failed[name]} [{card}]")
                    continue
                same = all(torch.equal(a, b) for a, b in zip(quant_call(lib, qq, kk), shipped))
                common.log(_line(name, f"quantizer {str(dtype).removeprefix('torch.')} {shape}", qms[name],
                                 qms["shipped"], same, f"; {common.bound_text(bound, sum(qms[name]) / 2)}")
                           + f" [{card}]")
            del qq, kk, shipped
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
