"""publish_ms.p90.varied: publish_ms.p90 in the cells that report
peer_rounds_per_s.varied (its reader, gpubench/metrics/publish_ms.p90.py)."""

from gpubench.harness import cells

read = cells.metric_reader("publish_ms.p90")
