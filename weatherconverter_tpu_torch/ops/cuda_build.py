"""Build and load the hand-written CUDA kernels in `csrc/`.

The kernels have a plain C interface, so nvcc builds them with no PyTorch
headers, in seconds, and `ctypes` loads the result. Each source compiles in
its own nvcc process, all started together (a source in `VARIANTS` once for
each of its flag sets), and one more links the objects into a shared
library. The build happens at first use, into `_build/` beside
the package (listed in .gitignore); the library's name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. nvcc's output is kept beside the library under the same hash, so
`build_log()` always speaks of the library that is loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("flash_fwd.cu", "flash_fwd_f32.cu", "flash_fwd_qk_i8.cu", "quantize_i8.cu", "flash_bwd.cu",
           "flash_bwd_f32.cu", "probe_exp2_attn.cu", "probe_qk_dot.cu", "probe_dw3x3.cu", "probe_dw9x9.cu")
HEADERS = ("flash_common.cuh", "flash_wgmma.cuh", "flash_fwd_loop.cuh", "flash_tf32.cuh")
# Sources compiled more than once, each time with other flags into an object of its own: K3-f32 once a head dim
# (its kernels) and once for its entry point, so that nvcc compiles the head dims in parallel
VARIANTS = {"flash_bwd_f32.cu": [()] + [(f"-DWC_BWD_F32_D={d}",) for d in (16, 32, 64, 128, 192)]}
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None
_build_log = ""

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def _compiles() -> list[tuple[str, tuple[str, ...], str]]:
    """(source, its extra flags, object name) of every nvcc compile of a build."""
    return [(s, flags, f"{s}.{i}.o") for s in SOURCES for i, flags in enumerate(VARIANTS.get(s, [()]))]


def _source_hash() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(VARIANTS.items()))).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every nvcc process; raise on the first that failed."""
    log, failed = "", None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)
    return log


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _build(target: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        compiles = _compiles()
        objs = [os.path.join(work, obj) for _, _, obj in compiles]
        log = _run([_start([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, os.path.join(CSRC_DIR, s)])
                    for (s, flags, _), obj in zip(compiles, objs)])
        tmp = os.path.join(work, "lib.so")
        log += _run([_start([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs])])
        with open(os.path.join(work, "log"), "w") as fh:
            fh.write(log)
        os.replace(fh.name, _log_path(target))  # the log first: a library on disk always has its log
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    return log


def _log_path(target: str) -> str:
    return os.path.splitext(target)[0] + ".log"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in this process."""
    global _library, _build_log
    with _lock:
        if _library is None:
            target = os.path.join(BUILD_DIR, f"libwc_flash_{_source_hash()}.so")
            if not (os.path.isfile(target) and os.path.isfile(_log_path(target))):
                _build_log = _build(target)
            else:
                with open(_log_path(target)) as fh:
                    _build_log = fh.read()
            lib = ctypes.CDLL(target)
            lib.wc_flash_fwd.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, ctypes.c_float, _ptr]
            lib.wc_flash_fwd.restype = _int
            lib.wc_flash_fwd_f32.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, ctypes.c_float, _ptr]
            lib.wc_flash_fwd_f32.restype = _int
            lib.wc_flash_fwd_qk_i8.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _ptr]
            lib.wc_flash_fwd_qk_i8.restype = _int
            strides = ctypes.POINTER(ctypes.c_longlong)
            lib.wc_quantize_qk_i8.argtypes = ([_ptr, _ptr, strides, strides] + [_int] * 6 + [_ptr] * 4
                                              + [ctypes.c_float, _ptr])
            lib.wc_quantize_qk_i8.restype = _int
            lib.wc_flash_bwd.argtypes = [_ptr] * 10 + [_int, _int, _int, _int, ctypes.c_float, _ptr]
            lib.wc_flash_bwd.restype = _int
            lib.wc_flash_bwd_f32.argtypes = [_ptr] * 10 + [_int, _int, _int, ctypes.c_float, _ptr]
            lib.wc_flash_bwd_f32.restype = _int
            lib.wc_probe_exp2_attn.argtypes = [_ptr] * 4 + [_int] * 4 + [ctypes.c_float, _ptr]
            lib.wc_probe_qk_i8.argtypes = [_ptr] * 3 + [_int] * 3 + [_ptr]
            lib.wc_probe_qk_bf16.argtypes = [_ptr] * 3 + [_int] * 3 + [_ptr]
            lib.wc_probe_dw3x3.argtypes = [_ptr] * 3 + [_int] * 5 + [_ptr]
            lib.wc_probe_dw_fma81.argtypes = [_ptr, _ptr, ctypes.c_longlong, _ptr, _int, _ptr]
            for fn in (lib.wc_probe_exp2_attn, lib.wc_probe_qk_i8, lib.wc_probe_qk_bf16, lib.wc_probe_dw3x3,
                       lib.wc_probe_dw_fma81):
                fn.restype = _int
            lib.wc_error_string.argtypes = [_int]
            lib.wc_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a cudaError_t other than 0."""
    if err != 0:
        msg = library().wc_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}: {msg}")


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, for a kernel's stream argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def build_log() -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills per
    kernel) from the build of the loaded library, by this process or an
    earlier one; empty before `library()` was called."""
    return _build_log
