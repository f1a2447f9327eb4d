"""heartbeat_ms.varied: heartbeat_ms in the cells that report
peer_rounds_per_s.varied (its reader, gpubench/metrics/heartbeat_ms.py)."""

from gpubench.harness import cells

read = cells.metric_reader("heartbeat_ms")
