"""vmem_gather_roofline: the vmem_gather kernel's share of its byte bound
in the profiled slice: bound (the (N, C) src read and out written once,
the (N,) t read once, over 3.35 TB/s; gpubench/harness/peaks.py) over the
mean device time of its launches, in %. Every launch of these cells is
at the cell's N x C. No launch, no reading. Moves peer_rounds_per_s."""

from gpubench.harness import peaks


def read(ctx):
    times = [e - s for name, s, e in ctx["slice"]["kernels"]
             if "vmem_gather" in name]
    if not times:
        return None
    mean_ms = sum(times) / len(times) * 1e-3
    return 100.0 * peaks.bound_ms(peaks.gather_bytes(ctx["n"], ctx["c"])) \
        / mean_ms
