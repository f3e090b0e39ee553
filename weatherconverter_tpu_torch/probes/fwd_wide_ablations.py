"""K1 and K2 at D = 192 (csrc/flash_fwd_wide.cuh) beside their ablations,
in one process on one card.

    python -m weatherconverter_tpu_torch.probes.fwd_wide_ablations

Each ablation undoes one choice of the wide block: a copy of csrc/ with that
edit (the anchor text must be found) is built into a library of its own
with nvcc (flash_fwd.cu, flash_fwd_qk_i8.cu and a stub for K2-f32's entry
point, all builds at once), and K1 (`wc_flash_fwd`) and K2's forward alone
(`wc_flash_fwd_qk_i8`, on this package's quantization) are timed at
(8, 4, 1024, 192), bf16, with `common.time_ms`, beside the shipped kernels,
in two rounds. Each line gives the times, whether the output equals the
shipped kernel's bit for bit, and its max|err|/max|ref| against the plain
version; and ptxas's spill line of each build's wide kernels. The
ablations:

  one_warpgroup   the one-warpgroup block of flash_fwd_loop.cuh at D = 192
                  for both (the design this one replaced)
  pv_n64          P V as three m64n64k16 MMAs a 16-key chunk, one a panel
  producer_40     setmaxnreg at 40 / 232 registers (producer / consumer)
  rings_2         two-deep K and V rings
  no_loads        K and V copied into the rings once; later tiles read
                  stale slots (wrong outputs): the kernel without its loads
  k2_two_blocks   K2 on the one-warpgroup block with two-deep rings (85 KB
                  of shared memory, two blocks an SM), the design tried
                  beside the wide one (K1 stays wide)

Exit 2 without a card.
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
WIDE = "flash_fwd_wide.cuh"
ABLATIONS = {
    "one_warpgroup": {
        "flash_fwd.cu": [("case 192: return launch_wide<T>(q, k, v, o, l, bh, n, scale, stream);",
                          "case 192: return launch<T, 192>(q, k, v, o, l, bh, n, scale, stream);")],
        "flash_fwd_qk_i8.cu": [("case 192: return launch_i8_wide<T>(", "case 192: return launch_i8<T, 192>(")]},
    "pv_n64": {WIDE: [("    Wgmma<T>::rs192(acc, p + 4 * c, desc_mnmajor<192>(v_tile, 0, c), "
                       "c == 0 ? accumulate : 1);",
                       "    mma_regs_tile<T, 192, 1>(acc, p + 4 * c, v_tile, 16 * c, c == 0 ? accumulate : 1);")]},
    "producer_40": {WIDE: [("constexpr int kWideProducerRegs = 24;", "constexpr int kWideProducerRegs = 40;"),
                           ("constexpr int kWideConsumerRegs = 240;", "constexpr int kWideConsumerRegs = 232;")]},
    "rings_2": {WIDE: [("constexpr int kWideStages = 3;", "constexpr int kWideStages = 2;")]},
    "no_loads": {WIDE: [
        ("        copy_tile<E, D>(k_ring + s * kKBytes, policy.k_head + (size_t)t * kTileRows * D, ptid);\n"
         "        mbar_arrive_copies(full_k + 8 * s);",
         "        if (t < kS) copy_tile<E, D>(k_ring + s * kKBytes, policy.k_head + (size_t)t * kTileRows * D, ptid);\n"
         "        mbar_arrive_copies(full_k + 8 * s);"),
        ("        copy_tile<T, D>(v_ring + s * L::kBytes, v_head + (size_t)u * kTileRows * D, ptid);\n"
         "        mbar_arrive_copies(full_v + 8 * s);",
         "        if (u < kS) copy_tile<T, D>(v_ring + s * L::kBytes, v_head + (size_t)u * kTileRows * D, ptid);\n"
         "        mbar_arrive_copies(full_v + 8 * s);")]},
    "k2_two_blocks": {
        "flash_fwd_loop.cuh": [("constexpr int kFwdStages = 3;", "constexpr int kFwdStages = 2;")],
        "flash_fwd_qk_i8.cu": [("case 192: return launch_i8_wide<T>(", "case 192: return launch_i8<T, 192>(")]},
}
STUB = ('extern "C" int wc_flash_fwd_qk_i8_f32(const void*, const void*, const float*, const float*, float*, int, '
        "int, int, int, void*) { return 1; }\n")


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
            text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)
    with open(os.path.join(src, "stub.cu"), "w") as fh:
        fh.write(STUB)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", os.path.join(src, "lib.so"),
           *(os.path.join(src, f) for f in ("flash_fwd.cu", "flash_fwd_qk_i8.cu", "stub.cu"))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wide_spills(log: str) -> str:
    lines = log.splitlines()
    found = [f"{'K2' if 'qk_i8' in ln else 'K1'} {lines[i + 2].strip()}" for i, ln in enumerate(lines)
             if "Compiling entry function" in ln and "nv_bfloat16" in ln
             and ("wide_kernel" in ln or "Li192ELi192E" in ln)]
    return "; ".join(found)


def main(argv=None) -> int:
    if not common.require_cuda("fwd_wide_ablations"):
        return 2
    card = common.card_line()
    common.log(card)
    common.log(common.setup())
    work = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR if os.path.isdir(cuda_build.BUILD_DIR) else None)
    try:
        builds = {name: _start_build(work, name, edits) for name, edits in ABLATIONS.items()}
        shipped = cuda_build.library()
        libs = {"shipped": shipped}
        for name, proc in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"ablation {name}: nvcc failed\n{log[-4000:]}")
            common.log(f"{name}: ptxas: {_wide_spills(log)}")
            lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
            for fn in ("wc_flash_fwd", "wc_flash_fwd_qk_i8"):
                getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        run(libs, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def run(libs: dict, card: str) -> None:
    b, h, n, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    q8, k8, qk_scale = A.quantize_qk_i8(q, k)
    stream = torch.cuda.current_stream().cuda_stream

    def k1(lib):
        o = torch.empty_like(q)
        cuda_build.check_launch("K1", lib.wc_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
                                                       b * h, n, d, 0, d**-0.5, stream))
        return o

    def k2(lib):
        o = torch.empty_like(q)
        cuda_build.check_launch("K2", lib.wc_flash_fwd_qk_i8(q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
                                                             qk_scale.data_ptr(), o.data_ptr(), b * h, n, d, 0, b * h,
                                                             stream))
        return o

    plain = {"K1": A.flash_attention_plain(q, k, v).float(), "K2": A.qk_i8_attention_plain(q8, k8, qk_scale, v).float()}
    ms = {name: {"K1": [], "K2": []} for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            for kernel, call in (("K1", k1), ("K2", k2)):
                ms[name][kernel].append(common.time_ms(lambda: call(lib), reps=20))
    for name, lib in libs.items():
        parts = []
        for kernel, call in (("K1", k1), ("K2", k2)):
            out, ref = call(lib), plain[kernel]
            same = torch.equal(out, call(libs["shipped"]))
            rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            runs = ms[name][kernel]
            parts.append(f"{kernel} {sum(runs) / 2:.4f} ms (runs {runs[0]:.4f}, {runs[1]:.4f}; shipped/this "
                         f"{sum(ms['shipped'][kernel]) / sum(runs):.3f}x), equal to shipped {same}, max|err|/max|ref| "
                         f"{rel:.2e}")
        common.log(f"{name} {SHAPE}: {'; '.join(parts)} [{card}]")
    common.log(f"sdpa forward {common.sdpa_ms(q, k, v):.4f} ms [{card}]")


if __name__ == "__main__":
    sys.exit(main())
