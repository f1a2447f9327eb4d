"""score_update_roofline: the score_update kernel's share of its byte
bound in the profiled slice, decay-only form (16 bytes an element of the
(N, C) counters; gpubench/harness/peaks.py), over the mean device time of
its launches, in %. No launch, no reading. Moves peer_rounds_per_s."""

from gpubench.harness import peaks


def read(ctx):
    times = [e - s for name, s, e in ctx["slice"]["kernels"]
             if "score_update" in name]
    if not times:
        return None
    mean_ms = sum(times) / len(times) * 1e-3
    return 100.0 * peaks.bound_ms(peaks.score_update_bytes(
        ctx["n"], ctx["c"], with_score=False)) / mean_ms
