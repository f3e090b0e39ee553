"""ctypes binding for the native batch decoder (port of
weatherconverter_tpu/data/native.py).

The library is the repository's `native/wcdecode.cpp`: libjpeg, libpng and
libdeflate decode, then a triangle-filter resize, a whole batch at a time on
C++ threads. The port builds its own copy with `g++` straight from that
source, with `native/Makefile`'s flags and libraries, into
`weatherconverter_tpu_torch/_build/libwcdecode.so`, stamped with the
source's sha256; it never runs `make -C native`, which rebuilds the tracked
`native/libwcdecode.so` in place. The build runs once, at the first decode
(never at import), and again when the source's hash changes or
WCTPU_NATIVE_REBUILD=1. WCTPU_NO_NATIVE=1 turns the decoder off.

JAX's contract: every function returns None when the library cannot be built
or loaded, and the datasets then decode with PIL (data/datasets.py).
`unavailable_reason()` says why (a missing header, no compiler, a stale ABI),
and `describe()` is the line the training loops print once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_ABI_VERSION = 2  # wc_abi_version() in native/wcdecode.cpp
HEADERS = ("jpeglib.h", "png.h", "libdeflate.h")
# native/Makefile:1-8: CXXFLAGS, then -shared -o $@ $<, then LDLIBS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng", "-ldeflate", "-lpthread")
CXX = "g++"
BUILD_TIMEOUT_S = 300

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "wcdecode.cpp")
LIBRARY = os.path.join(_PKG, "_build", "libwcdecode.so")


class _Native:
    """The loaded library, or why there is none; loaded once a process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.reason: Optional[str] = None


_STATE = _Native()


def _src_hash(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _compiler() -> Optional[str]:
    return shutil.which(CXX)


def missing_headers() -> list[str]:
    """The decoder's headers (HEADERS) the C++ compiler cannot find; every
    one of them when there is no compiler."""
    cxx = _compiler()
    if cxx is None:
        return list(HEADERS)
    missing = []
    for header in HEADERS:
        probe = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull], input=f"#include <{header}>\n",
                               capture_output=True, text=True, timeout=60)
        if probe.returncode != 0:
            missing.append(header)
    return missing


def _stamped(digest: str) -> bool:
    """Whether LIBRARY exists and its stamp holds `digest`."""
    stamp = LIBRARY + ".srchash"
    if not (os.path.exists(LIBRARY) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == digest


def _write_atomically(path: str, write) -> None:
    """Have `write(tmp)` fill a fresh temporary file beside `path`, then
    rename it over `path`, so no reader sees a half-written file."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(force: bool = False) -> str:
    """Compile SOURCE into LIBRARY unless its stamp holds the source's hash
    (always with `force`); returns LIBRARY. Raises RuntimeError with the
    compiler's first error line when the build fails. Processes that reach
    their first decode together (data-parallel ranks, test workers) build
    one at a time under a lock file in the build directory, and a process
    that waited finds the stamp its predecessor wrote."""
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"no decoder source at {SOURCE}")
    digest = _src_hash(SOURCE)
    if not force and _stamped(digest):
        return LIBRARY
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler: {CXX} is not on PATH")
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    with open(LIBRARY + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _stamped(digest):
            return LIBRARY

        def compile_to(tmp):
            res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp, SOURCE, *LDLIBS], capture_output=True,
                                 text=True, timeout=BUILD_TIMEOUT_S)
            if res.returncode != 0:
                lines = [ln for ln in res.stderr.splitlines() if "error" in ln] or res.stderr.splitlines() or ["?"]
                raise RuntimeError(f"{os.path.basename(cxx)} failed to build {SOURCE}: {lines[0].strip()}")

        def stamp_to(tmp):
            with open(tmp, "w") as f:
                f.write(digest + "\n")

        _write_atomically(LIBRARY, compile_to)
        _write_atomically(LIBRARY + ".srchash", stamp_to)
    return LIBRARY


def _bind_symbols(lib: ctypes.CDLL) -> None:
    lib.wc_abi_version.restype = ctypes.c_int
    lib.wc_abi_version.argtypes = []
    if lib.wc_abi_version() != _ABI_VERSION:
        raise RuntimeError(f"stale ABI: wc_abi_version() is {lib.wc_abi_version()}, the binding wants {_ABI_VERSION}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.wc_decode_box.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
    lib.wc_decode_exact.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
    lib.wc_decode_box_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.wc_decode_exact_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    for fn in (lib.wc_decode_box, lib.wc_decode_exact, lib.wc_decode_box_batch, lib.wc_decode_exact_batch):
        fn.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    with _STATE.lock:
        if _STATE.tried:
            return _STATE.lib
        _STATE.tried = True
        if os.environ.get("WCTPU_NO_NATIVE") == "1":
            _STATE.reason = "WCTPU_NO_NATIVE=1"
            return None
        try:
            lib = ctypes.CDLL(build(force=os.environ.get("WCTPU_NATIVE_REBUILD") == "1"))
            _bind_symbols(lib)
        except (RuntimeError, OSError, AttributeError, subprocess.TimeoutExpired) as e:
            _STATE.reason = str(e)
            return None
        _STATE.lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is missing (None when it is loaded)."""
    _load()
    return _STATE.reason


def describe() -> str:
    """Which decoder the datasets use, for a loop to print once."""
    if available():
        return f"decoder: native ({os.path.relpath(LIBRARY, os.path.dirname(_PKG))}, batch decode on C++ threads)"
    return f"decoder: PIL (native decoder unavailable: {unavailable_reason()})"


def _out_ptr(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def decode_box(path: str, smaller_side: int, out_hw: tuple[int, int], fast: bool = False) -> Optional[np.ndarray]:
    """HWC uint8: the smaller side resized to `smaller_side` (aspect kept),
    then center-cropped or edge-padded to `out_hw` (load_image_resized's
    box). fast=True permits JPEG DCT-domain pre-scaling (PIL draft()): a
    few levels off the full decode on JPEG, bit-equal on PNG."""
    lib = _load()
    if lib is None:
        return None
    th, tw = out_hw
    out = np.empty((th, tw, 3), dtype=np.uint8)
    rc = lib.wc_decode_box(os.fsencode(path), smaller_side, th, tw, _out_ptr(out), int(fast))
    return out if rc == 0 else None


def decode_exact(path: str, out_hw: tuple[int, int], fast: bool = False) -> Optional[np.ndarray]:
    """HWC uint8 resized to exactly `out_hw` (load_image_exact's)."""
    lib = _load()
    if lib is None:
        return None
    th, tw = out_hw
    out = np.empty((th, tw, 3), dtype=np.uint8)
    rc = lib.wc_decode_exact(os.fsencode(path), th, tw, _out_ptr(out), int(fast))
    return out if rc == 0 else None


def decode_box_batch(paths: Sequence[str], smaller_side: int, out_hw: tuple[int, int], nthreads: int = 0,
                     fast: bool = False) -> Optional[np.ndarray]:
    """NHWC uint8, `decode_box` of every path on `nthreads` C++ threads (0:
    the library's default); None if any file fails."""
    lib = _load()
    if lib is None:
        return None
    th, tw = out_hw
    out = np.empty((len(paths), th, tw, 3), dtype=np.uint8)
    fails = lib.wc_decode_box_batch(_paths_array(paths), len(paths), smaller_side, th, tw, _out_ptr(out), nthreads,
                                    int(fast))
    return out if fails == 0 else None


def decode_exact_batch(paths: Sequence[str], out_hw: tuple[int, int], nthreads: int = 0,
                       fast: bool = False) -> Optional[np.ndarray]:
    """NHWC uint8, `decode_exact` of every path; None if any file fails."""
    lib = _load()
    if lib is None:
        return None
    th, tw = out_hw
    out = np.empty((len(paths), th, tw, 3), dtype=np.uint8)
    fails = lib.wc_decode_exact_batch(_paths_array(paths), len(paths), th, tw, _out_ptr(out), nthreads, int(fast))
    return out if fails == 0 else None
