"""The card's published peaks and the byte arithmetic of the port's kernels.

NVIDIA H100 SXM (80 GB HBM3) data sheet: 3.35 TB/s of HBM bandwidth, 67
TFLOP/s float32 outside the tensor cores, both at the full 700 W power
limit. A kernel's bound is the larger of its bytes over the bandwidth and
its operations over the float32 rate; each input byte counts as read once
and each output byte as written once (chip_smoke.bound_ms, copied).
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3


def gather_bytes(n: int, c: int) -> int:
    """vmem_gather: out[q, j] = t[src[q, j]] over an (N, C) int32 src and
    an (N,) float32 t: the src read and the out written once (8 bytes an
    element) and t read once."""
    return n * c * 8 + n * 4


def score_update_bytes(n: int, c: int, with_score: bool) -> int:
    """score_update over (N, C) float32 counters: fmd and the slow-peer
    counter each read and written (16 bytes an element); the three-output
    form also writes the score (20)."""
    return n * c * (20 if with_score else 16)
