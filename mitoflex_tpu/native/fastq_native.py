"""ctypes bindings for the native FASTQ batch reader (fastq_reader.cpp).

The shared library (this reader plus dedup.cpp, merge.cpp and graph.cpp)
is built on first use from the tracked sources, with plain C ABI + ctypes.
The build lands in ``native/build/`` under a name keyed by the sources'
contents, the compiler flags and the host, so an edited source or a copy
of the tree on another machine triggers a rebuild, and a library built
elsewhere is never loaded. ``available()`` gates all use; the Python parser
in io/fastq.py is the drop-in fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "build")
_SRCS = ("fastq_reader.cpp", "dedup.cpp", "merge.cpp", "graph.cpp")
# portable flags (no -march=native): the library must run on any x86-64
# host the tree is copied to
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-Wall")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    """Where the library for these sources, flags and host lives."""
    h = hashlib.sha256()
    for f in _SRCS:
        with open(os.path.join(_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_CXXFLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return os.path.join(_BUILD_DIR, f"libmfxnative-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
           *(os.path.join(_DIR, f) for f in _SRCS), "-lz"]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    os.replace(tmp, path)  # atomic: concurrent builders never see a torn file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError) as e:
            from ..utils.logger import logger

            err = getattr(e, "stderr", b"") or b""
            logger.warn(f"native library unavailable ({e}) "
                        f"{err.decode(errors='replace')[-500:]}; "
                        "using the Python fallbacks")
            _build_failed = True
            return None
        lib.mfx_fastq_open.restype = ctypes.c_void_p
        lib.mfx_fastq_open.argtypes = [ctypes.c_char_p]
        lib.mfx_fastq_next_batch.restype = ctypes.c_long
        lib.mfx_fastq_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ]
        lib.mfx_fastq_bases_read.restype = ctypes.c_long
        lib.mfx_fastq_bases_read.argtypes = [ctypes.c_void_p]
        lib.mfx_fastq_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_batches(
    path: str, batch_reads: int, max_read_len: int, limit_bases: int = 0
) -> Iterator:
    """Yield ReadBatch objects (same contract as io/fastq.read_batches with
    keep_names=False)."""
    from ..io.fastq import ReadBatch

    lib = _load()
    assert lib is not None
    handle = lib.mfx_fastq_open(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        while True:
            seqs = np.full((batch_reads, max_read_len), 4, dtype=np.int8)
            quals = np.zeros((batch_reads, max_read_len), dtype=np.int8)
            lens = np.zeros(batch_reads, dtype=np.int32)
            n = lib.mfx_fastq_next_batch(
                handle,
                seqs.ctypes.data_as(ctypes.c_void_p),
                quals.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p),
                batch_reads, max_read_len, limit_bases,
            )
            if n <= 0:
                return
            yield ReadBatch(seqs, quals, lens, int(n), None)
            if n < batch_reads:
                return
    finally:
        lib.mfx_fastq_close(handle)
