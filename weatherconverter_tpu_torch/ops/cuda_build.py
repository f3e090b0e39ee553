"""Build and load the hand-written CUDA kernels in `csrc/`.

The kernels have a plain C interface, so nvcc builds them into one shared
library in seconds, with no PyTorch headers, and `ctypes` loads it. The build
happens at first use, into `_build/` beside the package (listed in
.gitignore); the library's name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.
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
SOURCES = ("flash_fwd.cu", "flash_fwd_qk_i8.cu")
HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _build(target: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in this process."""
    global _library, _build_log
    with _lock:
        if _library is None:
            target = os.path.join(BUILD_DIR, f"libwc_flash_{_source_hash()}.so")
            if not os.path.isfile(target):
                _build_log = _build(target)
            lib = ctypes.CDLL(target)
            lib.wc_flash_fwd.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, ctypes.c_float, _ptr]
            lib.wc_flash_fwd.restype = _int
            lib.wc_flash_fwd_qk_i8.argtypes = [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr]
            lib.wc_flash_fwd_qk_i8.restype = _int
            lib.wc_error_string.argtypes = [_int]
            lib.wc_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def build_log() -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills per
    kernel) from this process's build; empty when a cached library was used."""
    return _build_log
