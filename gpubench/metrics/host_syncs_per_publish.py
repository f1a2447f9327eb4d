"""host_syncs_per_publish: `aten::_local_scalar_dense` events (a device
value read on the host) inside the harness's `gpubench.publish` spans of
the profiled slice, per publish. Moves peer_rounds_per_s.varied."""


def read(ctx):
    d = ctx["slice"]
    pubs = d["span_cpu"]["gpubench.publish"]
    if not pubs:
        return None
    n = sum(1 for s, _ in d["syncs"]
            if any(a <= s < b for a, b in pubs))
    return n / len(pubs)
