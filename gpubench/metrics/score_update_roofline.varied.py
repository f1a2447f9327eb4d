"""score_update_roofline.varied: score_update_roofline in the cells that report
peer_rounds_per_s.varied (its reader, gpubench/metrics/score_update_roofline.py)."""

from gpubench.harness import cells

read = cells.metric_reader("score_update_roofline")
