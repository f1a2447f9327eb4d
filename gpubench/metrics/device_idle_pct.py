"""device_idle_pct: the share of the profiled slice's wall in which no
kernel ran on the card (1 - the union of kernel intervals / the wall),
in %. Moves peer_rounds_per_s."""


def read(ctx):
    d = ctx["slice"]
    if not d["kernels"] or d["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["wall_s"])
