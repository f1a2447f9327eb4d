"""Fused score-decay materialization: (decayed fmd, decayed slow, score).

Replaces the reference's Pallas kernel (dst_libp2p_test_node_tpu/native/
score_update.py:90, `_compiled`'s pallas_call, entry `score_update` :104,
plain formula `score_update_xla` :131). The reference kernel has no
production caller; the same decay runs on its main path as two
`_apply_decay` passes at the end of every heartbeat scan
(ops/heartbeat.py:533-535). The port calls this kernel at that site
(ops/heartbeat.run_heartbeats, ops/telemetry.run_recorded_heartbeats) in its
decay-only form, `with_score=False`, which returns (f, s, None): the same
kernel with the score store compiled out, so the counters stream through
once and no dead score is written. The three-output form is the TPU
kernel's counterpart (the registry contract, the launch sweep).

On a CUDA tensor the wrapper launches csrc/score_update.cu; on a CPU
tensor it runs the plain version. No probe, no switch: a CUDA call that
cannot build or launch the kernel raises.

`scales` is a (2,) float32 tensor [fmd_scale, slow_scale] on the counters'
device (the heartbeat scan's carried decay scalars).

The one launch parameter is the threads per block: `threads=` when the
caller passes it, else the tuning table's entry (native/tuned.py), else
DEFAULT_THREADS. An override must be a whole number of warps, 32 to 1024,
or the call raises; every value gives the same bytes. The kernel's grid is
as many blocks of that size as the card holds at once (a persistent grid).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, tuned

NAME = "score_update"
# kernel launches since the last reset (see native/vmem_gather.py)
launches = 0
DEFAULT_THREADS = 256
MIN_THREADS, MAX_THREADS, WARP = 32, 1024, 32


def decay_ref(fmd, slow_penalty, scales, params):
    """Plain-torch decay-only form: _apply_decay on both counters."""
    f = fmd * scales[0]
    s = slow_penalty * scales[1]
    f = torch.where(f < params.decay_to_zero, 0.0, f)
    s = torch.where(s < params.decay_to_zero, 0.0, s)
    return f, s


def score_update_ref(fmd, slow_penalty, scales, params):
    """Plain-torch version: _apply_decay on both counters, then the score
    formula (the reference's score_update_xla)."""
    f, s = decay_ref(fmd, slow_penalty, scales, params)
    score = (params.fmd_weight * torch.clamp_max(f, params.fmd_cap)
             + params.slow_weight * s)
    return f, s, score


def bind(lib: ctypes.CDLL) -> None:
    """Set the ctypes signature of a library's score_update_launch."""
    fn = lib.score_update_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    bind(lib)
    return lib


def launch_threads(threads=None) -> int:
    """The threads per block a launch uses (see module doc)."""
    if threads is not None:
        if not tuned.usable(threads, MIN_THREADS, MAX_THREADS, WARP):
            raise ValueError(f"score_update threads={threads!r}: want a "
                             f"multiple of {WARP} in [{MIN_THREADS}, "
                             f"{MAX_THREADS}]")
        return threads
    got = tuned.tuned_launch(NAME, MIN_THREADS, MAX_THREADS, WARP)
    return DEFAULT_THREADS if got is None else got


def score_update(fmd, slow_penalty, scales, params, *,
                 threads: int | None = None, with_score: bool = True):
    """(f, s, score) for the (N, C) float32 counters; (f, s, None) with
    `with_score=False` (see module doc)."""
    for x in (fmd, slow_penalty, scales):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError("score_update takes contiguous float32 tensors")
        if x.device != fmd.device:
            raise ValueError("score_update inputs must share one device")
    if fmd.shape != slow_penalty.shape or scales.shape != (2,):
        raise ValueError(f"bad shapes: fmd {tuple(fmd.shape)}, slow "
                         f"{tuple(slow_penalty.shape)}, scales "
                         f"{tuple(scales.shape)}")
    block = launch_threads(threads)
    if fmd.device.type == "cpu":
        if with_score:
            return score_update_ref(fmd, slow_penalty, scales, params)
        return (*decay_ref(fmd, slow_penalty, scales, params), None)
    if fmd.device.type != "cuda":
        raise ValueError(f"score_update has no kernel for {fmd.device}")
    global launches
    out = launch(_lib(), fmd, slow_penalty, scales, params, block,
                 with_score)
    launches += 1
    return out


def launch(lib, fmd, slow_penalty, scales, params, threads: int,
           with_score: bool):
    """One launch of `lib`'s kernel on checked CUDA tensors: the wrapper's
    body, and how native/score_bench.py launches edited libraries."""
    f, s = torch.empty_like(fmd), torch.empty_like(fmd)
    score = torch.empty_like(fmd) if with_score else None
    with torch.cuda.device(fmd.device):
        err = lib.score_update_launch(
            fmd.data_ptr(), slow_penalty.data_ptr(), scales.data_ptr(),
            f.data_ptr(), s.data_ptr(),
            None if score is None else score.data_ptr(), fmd.numel(),
            params.fmd_weight, params.slow_weight, params.fmd_cap,
            params.decay_to_zero, threads,
            torch.cuda.current_stream(fmd.device).cuda_stream)
    build.check_launch(lib, NAME, err)
    return f, s, score
