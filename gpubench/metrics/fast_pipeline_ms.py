"""fast_pipeline_ms: GPU extent of the program's
`disseminate.fast_pipeline` span (draws, fixpoints, pulls) per message
in the profiled slice. Moves peer_rounds_per_s."""


def read(ctx):
    d = ctx["slice"]
    spans = d["span_dev"]["disseminate.fast_pipeline"]
    if not spans or not d["publishes"]:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / d["publishes"]
