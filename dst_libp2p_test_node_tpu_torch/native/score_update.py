"""Fused score-decay materialization: (decayed fmd, decayed slow, score).

Replaces the reference's Pallas kernel (dst_libp2p_test_node_tpu/native/
score_update.py:90, `_compiled`'s pallas_call, entry `score_update` :104,
plain formula `score_update_xla` :131). The reference kernel has no
production caller; the same decay runs on its main path as two
`_apply_decay` passes at the end of every heartbeat scan
(ops/heartbeat.py:533-535). The port calls this kernel at that site
(ops/heartbeat.run_heartbeats), so the counters stream through once.

On a CUDA tensor the wrapper launches csrc/score_update.cu; on a CPU
tensor it runs `score_update_ref`. No probe, no switch: a CUDA call that
cannot build or launch the kernel raises.

`scales` is a (2,) float32 tensor [fmd_scale, slow_scale] on the counters'
device (the heartbeat scan's carried decay scalars).

The one launch parameter is the threads per block: `threads=` when the
caller passes it, else the tuning table's entry (native/tuned.py), else
DEFAULT_THREADS. An override must be a whole number of warps, 32 to 1024,
or the call raises; every value gives the same bytes.
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


def score_update_ref(fmd, slow_penalty, scales, params):
    """Plain-torch version: _apply_decay on both counters, then the score
    formula (the reference's score_update_xla)."""
    f = fmd * scales[0]
    s = slow_penalty * scales[1]
    f = torch.where(f < params.decay_to_zero, 0.0, f)
    s = torch.where(s < params.decay_to_zero, 0.0, s)
    score = (params.fmd_weight * torch.clamp_max(f, params.fmd_cap)
             + params.slow_weight * s)
    return f, s, score


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.score_update_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
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
                 threads: int | None = None):
    """(f, s, score) for the (N, C) float32 counters (see module doc)."""
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
        return score_update_ref(fmd, slow_penalty, scales, params)
    if fmd.device.type != "cuda":
        raise ValueError(f"score_update has no kernel for {fmd.device}")
    global launches
    f, s, score = (torch.empty_like(fmd) for _ in range(3))
    lib = _lib()
    with torch.cuda.device(fmd.device):
        err = lib.score_update_launch(
            fmd.data_ptr(), slow_penalty.data_ptr(), scales.data_ptr(),
            f.data_ptr(), s.data_ptr(), score.data_ptr(), fmd.numel(),
            params.fmd_weight, params.slow_weight, params.fmd_cap,
            params.decay_to_zero, block,
            torch.cuda.current_stream(fmd.device).cuda_stream)
    build.check_launch(lib, NAME, err)
    launches += 1
    return f, s, score
