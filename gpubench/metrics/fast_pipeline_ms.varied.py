"""fast_pipeline_ms.varied: fast_pipeline_ms in the cells that report
peer_rounds_per_s.varied (its reader, gpubench/metrics/fast_pipeline_ms.py)."""

from gpubench.harness import cells

read = cells.metric_reader("fast_pipeline_ms")
