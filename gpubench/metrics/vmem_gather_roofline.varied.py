"""vmem_gather_roofline.varied: vmem_gather_roofline in the cells that report
peer_rounds_per_s.varied (its reader, gpubench/metrics/vmem_gather_roofline.py)."""

from gpubench.harness import cells

read = cells.metric_reader("vmem_gather_roofline")
