"""Why the vmem_gather kernel takes the time it takes, on one CUDA card.

    python -m dst_libp2p_test_node_tpu_torch.native.gather_bench \\
        [--earlier path/to/earlier/vmem_gather.cu]

Builds the kernel of csrc/vmem_gather.cu as it stands and variants of it,
each made by a textual edit of that source (VARIANTS below), plus, with
--earlier, an earlier source whose C launcher takes the same arguments
(blocks_per_sm included) and an edit of it that drops its per-element
64-bit division. Every library is held bitwise
against `vmem_gather_ref` at ragged and full shapes, then all are timed at
the main path's shape, 1M peers x 40 slots, L2-cold (runtime/microbench.
mean_launch_s: the mean of ITERS calls, the cache flushed before each and
each between its own CUDA events), in turns (forward then backward order;
the lower mean of the two counts).
Yardsticks on the kept kernel: the same src sorted ascending (the t reads
become sequential: the gap to random is the cost of the random reads), and
random indices into a 2048-entry t (8 KB, resident in L1: the gap to the 1M
t is what the random reads cost beyond L1). Prints one line per number and
a JSON object as the last line.

The variants are measurement only: the package builds csrc/vmem_gather.cu
unedited. Every library launches with the wrapper's default blocks per SM;
the blocks-per-SM sweep is the microbench harness's (runtime/
microbench.py sweep_kernels), since that number is a launch argument.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

from ..runtime.microbench import mean_launch_s
from . import build
from .vmem_gather import DEFAULT_BLOCKS_PER_SM, vmem_gather_ref

FULL_N, FULL_C = 1_000_000, 40
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
SMALL_T = 2048
ITERS = 100

_KEPT = "vmem_gather.cu"

# Output path not kept: each tile's results go to one of two shared-memory
# buffers and leave with one TMA bulk store (cp.async.bulk.global.
# shared::cta.bulk_group); a buffer is rewritten only after the store that
# read it two tiles earlier has finished reading (wait_group.read 1).
_TMA_STORE = [
    ("constexpr int kSmemBytes = kRingBytes + kStages * 8;",
     "constexpr int kOutBytes = 2 * kTile * 4;\n"
     "constexpr int kSmemBytes = kRingBytes + kOutBytes + kStages * 8;"),
    ("const uint32_t bar_s = ring_s + kRingBytes;",
     "const uint32_t bar_s = ring_s + kRingBytes + kOutBytes;"),
    ("    __syncthreads();  // every warp holds its indices: refill the stage",
     "    if (threadIdx.x == 0)\n"
     "      asm volatile(\"cp.async.bulk.wait_group.read 1;\" ::: \"memory\");\n"
     "    __syncthreads();  // every warp holds its indices: refill the stage"),
    ("""    float4* out4 = reinterpret_cast<float4*>(out + start);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) __stcs(out4 + v, val[i]);
    }
  }
""",
     """    float4* obuf = reinterpret_cast<float4*>(smem + kRingBytes) +
                   (k & 1) * (kTile / 4);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) obuf[v] = val[i];
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && nvec > 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
          " [%0], [%1], %2, %3;"
          :: "l"(out + start), "r"(smem_addr(obuf)), "r"(nvec * 16),
             "l"(stream_pol) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
"""),
]

# no L2 policy anywhere (cause 3 of the design note): t through __ldg, the
# bulk copy without a cache hint, plain stores
_DEFAULT_L2 = [
    ("""  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));""",
     """  v = __ldg(p);
  (void)pol;"""),
    ("""".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(pol)""",
     """" [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)"""),
    ("if (v < nvec) __stcs(out4 + v, val[i]);",
     "if (v < nvec) out4[v] = val[i];"),
]


def _const(name: str, old: int, new: int):
    return [(f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")]


VARIANTS = {
    "kept": [],
    "tma_store": _TMA_STORE,
    "default_l2": _DEFAULT_L2,
    "stages2": _const("kStages", 3, 2),
    "stages4": _const("kStages", 3, 4),
    "tile1024": _const("kTile", 2048, 1024),
    "tile4096": _const("kTile", 2048, 4096),
}

# the earlier kernel without its per-element 64-bit division when batch is 1
_EARLIER_NO_DIV = [("const int64_t b = i / per_batch;",
                "const int64_t b = per_batch == total ? 0 : i / per_batch;")]


def edited(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"edit anchor found {source.count(old)} times: "
                             f"{old[:60]!r}")
        source = source.replace(old, new)
    return source


def _bind_gather(lib: ctypes.CDLL) -> None:
    lib.vmem_gather_launch.restype = ctypes.c_int
    lib.vmem_gather_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]


def build_all(sources: dict[str, str],
              bind=_bind_gather) -> dict[str, ctypes.CDLL]:
    """nvcc every source at once (the package's flags); load each and set
    its launcher's ctypes signature with `bind`."""
    out_dir = os.path.join(build.BUILD_DIR, "bench")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name, text in sources.items():
        digest = hashlib.sha256(
            (text + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:16]
        cu = os.path.join(out_dir, f"{name}-{digest}.cu")
        so = cu[:-3] + ".so"
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, None if os.path.exists(so) else subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"[build] {name}: " + " | ".join(regs))
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n"
                                   f"{log}")
        lib = ctypes.CDLL(so)
        bind(lib)
        libs[name] = lib
    return libs


def gather(lib, t, src):
    """One launch of `lib`'s kernel with the wrapper's arguments."""
    batch = src.shape[0] if src.dim() == 3 else 1
    n_src = t.shape[-1]
    out = torch.empty(src.shape, dtype=torch.float32, device=src.device)
    err = lib.vmem_gather_launch(
        t.data_ptr(), src.data_ptr(), out.data_ptr(), batch,
        src.numel() // batch, n_src, n_src if t.dim() == 2 else 0,
        DEFAULT_BLOCKS_PER_SM, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cuda error {err}")
    return out


def inputs(n, c, gen, batch=None, n_src=None):
    n_src = n if n_src is None else n_src
    shape = (n, c) if batch is None else (batch, n, c)
    t = torch.rand((n_src,) if batch is None else (batch, n_src),
                   generator=gen, device="cuda") * 4000.0
    t[..., ::7] = 3.4e38
    src = torch.randint(0, n_src, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    pad = torch.rand(shape, generator=gen, device="cuda") < 0.1
    return t, torch.where(pad, -1, src).to(torch.int32)


def cuda_ms(fn, iters):
    """Mean ms of one L2-cold call after a warm-up (mean_launch_s)."""
    fn()
    torch.cuda.synchronize()
    dev = torch.device("cuda", torch.cuda.current_device())
    return mean_launch_s(fn, iters, dev) * 1e3


def check_all(libs, gen):
    cases = []
    for n, c in ((999, 37), (31, 7), (1, 1), (0, 40), (FULL_N, FULL_C)):
        t, src = inputs(max(n, 1), c, gen)
        cases.append((f"{n}x{c}", t, src[:n]))
        if n > 1:
            tb, srcb = inputs(n, c, gen, batch=3)
            cases += [(f"3x{n}x{c} per-row t", tb, srcb),
                      (f"3x{n}x{c} shared t", t, srcb)]
    for name, lib in libs.items():
        for label, t, src in cases:
            got = gather(lib, t, src)
            want = vmem_gather_ref(t, src)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).flatten().nonzero()
                raise SystemExit(f"{name} != vmem_gather_ref at {label}: "
                                 f"{bad.numel()} elements differ, first at "
                                 f"flat index {int(bad[0])}")
    print(f"[check] {', '.join(libs)} bitwise equal to vmem_gather_ref at "
          + ", ".join(label for label, _, _ in cases))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", help="an earlier vmem_gather.cu with the same "
                    "launcher, timed beside the kept one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device", file=sys.stderr)
        return 1
    with open(os.path.join(build.CSRC_DIR, _KEPT)) as f:
        kept = f.read()
    sources = {name: edited(kept, e) for name, e in VARIANTS.items()}
    if args.earlier:
        with open(args.earlier) as f:
            earlier = f.read()
        sources["earlier"] = earlier
        sources["earlier_no_div"] = edited(earlier, _EARLIER_NO_DIV)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    libs = build_all(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_all(libs, gen)

    t, src = inputs(FULL_N, FULL_C, gen)
    bound = (2 * src.numel() + t.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    order = list(libs) + list(libs)[::-1]
    times: dict[str, float] = {}
    for name in order:
        ms = cuda_ms(lambda lib=libs[name]: gather(lib, t, src), ITERS)
        times[name] = min(times.get(name, ms), ms)
    kept_lib = libs["kept"]
    sorted_src = src.flatten().sort().values.view_as(src).contiguous()
    t_small, src_small = inputs(FULL_N, FULL_C, gen, n_src=SMALL_T)
    yard = {}
    for label, fn in (("random", lambda: gather(kept_lib, t, src)),
                      ("sorted", lambda: gather(kept_lib, t, sorted_src)),
                      ("random_small_t",
                       lambda: gather(kept_lib, t_small, src_small)),
                      ("random", lambda: gather(kept_lib, t, src))):
        ms = cuda_ms(fn, ITERS)
        yard[label] = min(yard.get(label, ms), ms)
    for name, ms in times.items():
        print(f"[time] {name}: {ms:.4f} ms at {FULL_N}x{FULL_C} "
              f"({bound / ms:.1%} of the {bound:.4f} ms byte bound)")
    print(f"[yardstick] kept kernel at {FULL_N}x{FULL_C}: random src "
          f"{yard['random']:.4f} ms, sorted src {yard['sorted']:.4f} ms, "
          f"random into a {SMALL_T}-entry t {yard['random_small_t']:.4f} ms; "
          f"bound {bound:.4f} ms")
    print(json.dumps({"card": smi, "shape": [FULL_N, FULL_C],
                      "bound_ms": bound, "ms": times, "yardsticks_ms": yard},
                     allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
