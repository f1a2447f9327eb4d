"""Build and load the port's CUDA kernels.

Each source in csrc/ is compiled by nvcc, on first use, into a shared
library with a plain C interface (`extern "C"` launchers), loaded with
ctypes and called with `data_ptr()`s and the current stream's handle. No
PyTorch headers are involved, so a build takes seconds, and no `ninja` is
needed. Libraries land in native/_build/ (listed in .gitignore), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Each kernel is one self-contained .cu that
includes no header of its own, so that hash covers everything it is built
from. `build()` starts one nvcc per missing library, all
at once, and waits for all of them. A failed build raises with nvcc's
output; nothing falls back.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o native/_build/<name>-<hash>.so \\
         native/csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# kernel name -> source file under csrc/
KERNELS = {
    "vmem_gather": "vmem_gather.cu",
    "score_update": "score_update.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output (including -Xptxas -v register/spill lines) per kernel
build_logs: dict[str, str] = {}
# one-time work since import: nvcc processes started and libraries loaded
# (runtime/profiling.count_retraces reads their sum)
nvcc_builds = 0
library_loads = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels cannot be built")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, KERNELS[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, str]:
    """Compile every missing library among `names` (default: all kernels)
    in parallel; returns {name: library path}. Raises on any failure."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    global nvcc_builds
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, KERNELS[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        nvcc_builds += 1
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    global library_loads
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
            library_loads += 1
        return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} launch failed: {fn(err).decode()} (cuda error {err})")
