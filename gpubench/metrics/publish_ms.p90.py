"""publish_ms.p90: the 90th percentile of the host wall of every publish
in the traced run's window, each ending in a synchronize so that the
message's state write-back is in it. Moves peer_rounds_per_s."""

import statistics


def read(ctx):
    walls = ctx["run"].publish_walls
    if len(walls) < 2:
        return None
    return statistics.quantiles([w * 1e3 for w in walls], n=10)[8]
