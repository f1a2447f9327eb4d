"""device_idle_pct.varied: device_idle_pct in the cells that report
peer_rounds_per_s.varied (its reader, gpubench/metrics/device_idle_pct.py)."""

from gpubench.harness import cells

read = cells.metric_reader("device_idle_pct")
