"""Bulk latency-line formatting through the native emitter.

`format_block` renders all of one message's latencies-file lines with the
C++ emitter native/logemit.cpp, loaded with ctypes. The library is built
at first use with

    g++ -O2 -shared -fPIC -o native/_build/logemit-<hash>.so native/logemit.cpp

named by a hash of the source and the flags, so an edited source is
rebuilt. A failed build raises with g++'s output: nothing falls back.
The plain version is runtime/logemit.grep_lines (the tests hold the two
byte for byte).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..native.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(BUILD_DIR), "logemit.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
# the emitter refuses to start a line with less room than this
_LINE_GUARD = 160

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"logemit-{digest.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The emitter's library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the log emitter failed (g++ exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        ptr = ctypes.POINTER(ctypes.c_longlong)
        lib.format_block.restype = ctypes.c_longlong
        lib.format_block.argtypes = [ctypes.c_ulonglong, ptr, ptr, ptr,
                                     ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_longlong]
        _lib = lib
        return lib


def format_block(msg_id: int, peers: np.ndarray, linenos: np.ndarray,
                 delays: np.ndarray) -> str:
    """All lines of one message, each ending in a newline: grep_lines'
    text for the same arguments."""
    lib = load()
    ptr = ctypes.POINTER(ctypes.c_longlong)
    cols = [np.ascontiguousarray(x, dtype=np.int64)
            for x in (peers, linenos, delays)]
    cap = len(cols[0]) * _LINE_GUARD + 16
    out = np.empty(cap, dtype=np.uint8)
    written = lib.format_block(
        ctypes.c_ulonglong(int(msg_id) & 0xFFFFFFFFFFFFFFFF),
        *(c.ctypes.data_as(ptr) for c in cols), len(cols[0]),
        out.ctypes.data, cap)
    if written < 0:
        raise RuntimeError("the log emitter's buffer was too small")
    return out[:written].tobytes().decode("ascii")
