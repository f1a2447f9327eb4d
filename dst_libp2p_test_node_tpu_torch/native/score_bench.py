"""Why the score_update kernel takes the time it takes, on one CUDA card.

    python -m dst_libp2p_test_node_tpu_torch.native.score_bench \\
        [--earlier path/to/earlier/score_update.cu]

Builds the kernel of csrc/score_update.cu as it stands and variants of it,
each made by a textual edit of that source (VARIANTS below): the inputs'
load hint and L2 prefetch size, a streaming (evict-first) store for the score or for all three
outputs, fewer or more float4s per thread and iteration, and half the
resident grid. With --earlier it also builds an earlier source whose C
launcher takes the same arguments, timed in the three-output form only
(an earlier kernel may have no decay-only form). Every library is held
against the plain version (`score_update_ref`: the counters bitwise, the
score within rtol 1e-5 / atol 1e-6) in both forms at ragged shapes,
offset views and the main shapes, then all are timed at the main paths'
shapes (100k, 670k and 1M x 40) in both forms, L2-cold
(runtime/microbench.mean_launch_s: the mean of ITERS launches, the cache
flushed before each), in turns (forward then backward order; the lower
mean counts). Yardsticks beside them, each against its own byte bound:
PyTorch's own streaming kernels on one counter, `copy_` (4 bytes read
and 4 written an element) and `fill_` (4 written): what share of the
data sheet's rate this card's memory gives a read / write mix and
writes alone. Prints one line per number and a JSON object as the last line.

The variants are measurement only: the package builds csrc/score_update.cu
unedited. Every library launches with the wrapper's default threads per
block; the threads sweep is the microbench harness's (runtime/
microbench.py sweep_kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..ops.state import SimParams
from ..runtime.microbench import mean_launch_s
from . import build
from .gather_bench import build_all, edited
from .score_update import DEFAULT_THREADS, bind, launch, score_update_ref

SHAPES = ((100_000, 40), (670_000, 40), (1_000_000, 40))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
ITERS = 20
RTOL, ATOL = 1e-5, 1e-6

_KEPT = "score_update.cu"

_LD4 = ('''  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));''')
# the float4 body's stores as they stand in the kernel, each against the
# same store through __stcs (evict-first in L1 and L2)
_ST_F = ("  f_out[v] = f;", "  __stcs(f_out + v, f);")
_ST_S = ("  s_out[v] = s;", "  __stcs(s_out + v, s);")
_ST_SCORE = ("    score_out[v] = sc;", "    __stcs(score_out + v, sc);")


def _unroll(n: int):
    return [("constexpr int kUnroll = 2;", f"constexpr int kUnroll = {n};")]


VARIANTS = {
    "kept": [],
    # the inputs through ld.global.cs (evict-first in L1 and L2)
    "ld_cs": [(_LD4, "  v = __ldcs(p);")],
    # the inputs through the plain non-coherent path (L1 allocating)
    "ld_nc": [(_LD4, "  v = __ldg(p);")],
    # the same loads asking L2 to fetch 256-byte blocks from memory
    "ld_l2_256": [(_LD4, _LD4.replace("no_allocate.v4",
                                      "no_allocate.L2::256B.v4"))],
    "st_cs_score": [_ST_SCORE],
    "st_cs_all": [_ST_SCORE, _ST_F, _ST_S],
    "unroll1": _unroll(1),
    "unroll4": _unroll(4),
    "half_grid": [("*out = (int64_t)occ * sm_count[dev];",
                   "*out = (int64_t)(occ > 1 ? occ / 2 : 1) * "
                   "sm_count[dev];")],
}


def _params(n, c):
    return SimParams(n=max(n, 1), capacity=c, slow_weight=-10.0)


def _counters(n, c, gen):
    return (torch.rand((n, c), generator=gen, device="cuda") * 3.0,
            torch.rand((n, c), generator=gen, device="cuda") * 0.5)


def check_all(libs, forms, scales, gen):
    """Every library in each of its forms against the plain version."""
    cases = [(f"{n}x{c}", *_counters(n, c, gen))
             for n, c in ((1000, 37), (999, 37), (0, 40))]
    base_f, base_s = _counters(1001, 37, gen)
    other_s = _counters(1002, 37, gen)[1]
    cases += [("x[1:] of 1001x37", base_f[1:], base_s[1:]),
              ("fmd x[1:] against slow x[2:]", base_f[1:], other_s[2:])]
    cases += [(f"{n}x{c}", *_counters(n, c, gen)) for n, c in SHAPES]
    for label, fmd, slow in cases:
        params = _params(*fmd.shape)
        want = score_update_ref(fmd, slow, scales, params)
        for name, lib in libs.items():
            for with_score in forms[name]:
                got = launch(lib, fmd, slow, scales, params, DEFAULT_THREADS,
                             with_score)
                torch.cuda.synchronize()
                ok = (torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])
                      and (not with_score or torch.allclose(
                          got[2], want[2], rtol=RTOL, atol=ATOL)))
                if not ok:
                    raise SystemExit(f"{name} (with_score={with_score}) != "
                                     f"score_update_ref at {label}")
    print(f"[check] {', '.join(libs)} equal to score_update_ref (counters "
          f"bitwise, score within rtol {RTOL} / atol {ATOL}) at "
          + ", ".join(label for label, _, _ in cases))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", help="an earlier score_update.cu with the "
                    "same launcher, timed beside the kept one (three-output "
                    "form)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("score_bench: no CUDA device", file=sys.stderr)
        return 1
    with open(os.path.join(build.CSRC_DIR, _KEPT)) as f:
        kept = f.read()
    sources = {name: edited(kept, e) for name, e in VARIANTS.items()}
    forms = {name: (True, False) for name in sources}
    if args.earlier:
        with open(args.earlier) as f:
            sources["earlier"] = f.read()
        forms["earlier"] = (True,)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    libs = build_all(sources, bind=bind)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(0)
    scales = torch.tensor([0.9 ** 7, 0.2 ** 3], dtype=torch.float32,
                          device="cuda")
    check_all(libs, forms, scales, gen)

    result: dict = {}
    for n, c in SHAPES:
        fmd, slow = _counters(n, c, gen)
        params = _params(n, c)
        runs = [(name, w) for name in libs for w in forms[name]]
        times: dict = {}
        for name, with_score in runs + runs[::-1]:
            ms = mean_launch_s(
                lambda lib=libs[name], w=with_score: launch(
                    lib, fmd, slow, scales, params,  # noqa: B023
                    DEFAULT_THREADS, w), ITERS, dev) * 1e3
            key = f"{name}/{'three' if with_score else 'decay'}"
            times[key] = min(times.get(key, ms), ms)
        out = torch.empty_like(fmd)
        yard = {label: min(mean_launch_s(fn, ITERS, dev)
                           for _ in range(2)) * 1e3
                for label, fn in (("copy", lambda: out.copy_(fmd)),
                                  ("write", lambda: out.fill_(1.0)))}
        bounds = {form: fmd.numel() * per / HBM_BYTES_PER_S * 1e3
                  for form, per in (("three", 20), ("decay", 16),
                                    ("copy", 8), ("write", 4))}
        for key, ms in times.items():
            b = bounds[key.split("/")[1]]
            print(f"[time] {key} at {n}x{c}: {ms:.4f} ms ({b / ms:.1%} of "
                  f"the {b:.4f} ms byte bound)")
        for label, ms in yard.items():
            print(f"[yardstick] {label} of one counter at {n}x{c}: "
                  f"{ms:.4f} ms ({bounds[label] / ms:.1%} of its "
                  f"{bounds[label]:.4f} ms byte bound)")
        result[f"{n}x{c}"] = {"ms": times, "yardsticks_ms": yard,
                              "bound_ms": bounds}
        del fmd, slow, out
    print(json.dumps({"card": smi, "threads": DEFAULT_THREADS,
                      "l2_cold": True, "shapes": result}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
