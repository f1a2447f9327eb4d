"""heartbeat_ms: host milliseconds per heartbeat over the traced run's
window: each advance's wall (ending in a synchronize) summed, over the
heartbeats they ran. Moves peer_rounds_per_s."""


def read(ctx):
    run = ctx["run"]
    if not run.advance_walls or not run.heartbeats:
        return None
    return sum(run.advance_walls) * 1e3 / run.heartbeats
