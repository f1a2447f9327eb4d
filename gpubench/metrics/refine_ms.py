"""refine_ms: GPU extent of the program's `disseminate.refinement` span
per message in the profiled slice (exact delivery's refinement; no span,
no reading). Moves peer_rounds_per_s.varied."""


def read(ctx):
    d = ctx["slice"]
    spans = d["span_dev"]["disseminate.refinement"]
    if not spans or not d["publishes"]:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / d["publishes"]
