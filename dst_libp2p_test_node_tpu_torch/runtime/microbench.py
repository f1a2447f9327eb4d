"""Microbenchmark + kernel launch tuning harness (the reference's
runtime/microbench.py on the card).

arXiv:1912.03413's methodology applied to the registered entry points:
measure where each sits against its bound BEFORE optimizing it, and pick
the kernels' launch parameters from measurement. Three sections, each
strict JSON:

  rooflines      per EntrypointContract (analysis/registry.py) the
                 profiling.roofline block {flops, hbm_bytes,
                 peak_memory_bytes, retraces, retrace_budget,
                 new_segments, host_syncs}, extended with a min-of-k wall
                 (CUDA events around the call on the card, the host clock
                 on the CPU), and on the card the byte bound at 3.35 TB/s
                 (H100 SXM data sheet), the share bound / wall and the
                 achieved bytes/s. At the registry's audit shapes (32-2,048
                 peers) every entry point is launch-bound: shares far
                 below 1% are expected there and are no finding.
  kernel_sweep   every candidate launch parameter of both CUDA kernels
                 (native/tuned.py: vmem_gather's persistent blocks per SM,
                 1 to the kernel's occupancy limit; score_update's threads
                 per block, 32 to 1024, in its three-output form and, as
                 the row `score_update_decay_only`, in the decay-only form
                 the main path launches) timed L2-cold (mean_launch_s:
                 the cache flushed before every launch, each launch
                 between its own CUDA events) through the wrappers'
                 override keyword at each swept shape, each candidate's
                 output held against the plain version in the same call
                 (the gather and the decayed counters bitwise, the score
                 within rtol 1e-5 / atol 1e-6): a candidate that differs
                 raises. The winners become the `tuned` table (score_update's
                 entry is the decay-only form's winner); `--install`
                 writes it through native/tuned.tuned_path() and drops the
                 wrappers' cached table. On the CPU the plain version runs
                 (`interpret: true`): a functional sweep of the path and
                 the artifact, not a performance claim.
  packed_state_ab
                 the SimParams.packed_state A/B (bf16 per-edge cost tables
                 on the receiver-side fixpoint): one timed exact publish
                 per setting, and whether the flag changed the program at
                 all. The reference compares lowered-HLO hashes; here the
                 program is the dispatch route (the receiver-side
                 formulation, the only reader of the flag, runs above the
                 row-gather budget) and the op log of one publish (every
                 dispatched aten op and kernel launch); on the card the
                 profiler's kernel-launch log is reported beside it. The
                 verdict keeps the default off: exact delivery is the
                 model of record and bf16 packing breaks its bit
                 guarantee, so a wall alone never flips it.

CLI: `python -m dst_libp2p_test_node_tpu_torch microbench [--out FILE]
[--install] [--only PREFIX] [--no-retraces] [--no-rooflines] [--no-sweep]
[--no-packed] [--sweep-rows N[,N...]] [--sweep-cap C] [--packed-n N]
[--reps K] [--device cpu]`. The card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

# H100 SXM: 3.35 TB/s HBM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# the main paths' shapes: config 4's 100k x 40, the service's 670k x 40
# (10,000 peers x 67 topics) and the 1M x 40 run
SWEEP_ROWS = (100_000, 670_000, 1_000_000)
SWEEP_CAP = 40
# score_update's candidates: powers of two from one warp to the block limit
THREAD_CANDIDATES = (32, 64, 128, 256, 512, 1024)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# sweep rows whose winner is another row's table entry: score_update's
# threads are picked on the decay-only form, the one the main path launches
# (ops/heartbeat.run_heartbeats, ops/telemetry); both forms are one kernel
# template and one table entry
TUNES = {"score_update_decay_only": "score_update"}


def _wall_s(thunk, device) -> float:
    """Seconds of one call: CUDA events on the card, the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        thunk()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    thunk()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _min_wall(thunk, reps: int, device) -> float:
    """Min-of-reps wall of an already-warm thunk."""
    return min(_wall_s(thunk, device) for _ in range(max(reps, 1)))


def flush_l2(device) -> None:
    """Evict the CUDA `device`'s L2 cache before a timed launch: write a
    buffer of twice its size (`L2_cache_size` of the device's properties).
    The buffer comes from the caching allocator and goes back to it at
    once, so no memory stays held between launches. Raises ValueError on
    a device that is not CUDA: a CPU sweep times with the host clock and
    never calls it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"flush_l2 needs a CUDA device, not {device}")
    size = 2 * torch.cuda.get_device_properties(device).L2_cache_size
    torch.empty(size, dtype=torch.uint8, device=device).fill_(0)


# cycles the card idles before a timed run while the host queues every
# launch of it (about 0.25 ms of host work a launch at ~2 GHz), so that no
# host gap falls between a launch's two events
QUEUE_CYCLES_PER_LAUNCH = 500_000


def mean_launch_s(thunk, iters: int, device) -> float:
    """Mean seconds of one call over `iters` calls of an already-warm
    thunk. On the card every call is L2-cold: `flush_l2` runs just before
    it, outside the call's own pair of CUDA events, so a time never
    depends on what ran before. Each call's output is dropped before the
    next. On the CPU: the host clock around the calls, no flush."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            thunk()
        return (time.perf_counter() - t0) / iters
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    with torch.cuda.device(device):
        torch.cuda._sleep(QUEUE_CYCLES_PER_LAUNCH * iters)
        for start, end in pairs:
            flush_l2(device)
            start.record()
            thunk()
            end.record()
        torch.cuda.synchronize(device)
    return sum(s.elapsed_time(e) for s, e in pairs) / iters / 1e3


def registry_rooflines(name_prefix: str | None = None,
                       with_retraces: bool = True, reps: int = 3,
                       device=None) -> dict:
    """The profiling.roofline block per contract, extended with a measured
    wall and, on the card, the byte bound and the share bound / wall. A
    contract that fails degrades to an `error` entry."""
    from ..analysis.jaxpr_audit import run_spec, spec_device
    from ..analysis.registry import default_contracts
    from .profiling import roofline

    contracts = default_contracts(device)
    if name_prefix:
        contracts = [c for c in contracts if c.name.startswith(name_prefix)]
    block = roofline(contracts, with_retraces=with_retraces)
    for c in contracts:
        entry = block[c.name]
        if "error" in entry:
            continue
        try:
            spec = c.build()
            dev = spec_device(spec)
            run_spec(spec)                                  # warm
            wall = _min_wall(lambda: run_spec(spec), reps, dev)  # noqa: B023
            entry["wall_s"] = wall
            if dev.type == "cuda" and wall > 0:
                entry["bound_s"] = entry["hbm_bytes"] / HBM_BYTES_PER_S
                entry["share"] = entry["bound_s"] / wall
                entry["hbm_gbytes_per_s"] = entry["hbm_bytes"] / wall / 1e9
        except Exception as e:  # noqa: BLE001 — per-entry degradation
            entry["error"] = repr(e)[:200]
    return block


def _inputs(n_rows: int, cap: int, device):
    """Seeded inputs of both kernels at one shape: the gather's t (with
    unreached senders) and src (10% -1 pads), the score's counters and
    decay scales."""
    gen = torch.Generator(device=device).manual_seed(0)
    t = torch.rand((n_rows,), generator=gen, device=device) * 4000.0
    t[::7] = 3.4e38
    src = torch.randint(0, n_rows, (n_rows, cap), generator=gen,
                        device=device, dtype=torch.int32)
    pad = torch.rand((n_rows, cap), generator=gen, device=device) < 0.1
    src = torch.where(pad, -1, src).to(torch.int32)
    fmd = torch.rand((n_rows, cap), generator=gen, device=device) * 3.0
    slow = torch.rand((n_rows, cap), generator=gen, device=device) * 0.5
    scales = torch.tensor([0.9 ** 7, 0.2 ** 3], dtype=torch.float32,
                          device=device)
    return t, src, fmd, slow, scales


def gather_candidates(device) -> list[int]:
    """vmem_gather's blocks per SM: 1 to the kernel's occupancy limit on
    the card. On the CPU, MAX_BLOCKS_PER_SM, the argument check's range:
    a CPU sweep checks the plumbing, not the card's candidate set."""
    from ..native import vmem_gather as vg

    hi = (vg.max_blocks_per_sm(device) if device.type == "cuda"
          else vg.MAX_BLOCKS_PER_SM)
    return list(range(1, hi + 1))


def sweep_kernels(n_rows: int = SWEEP_ROWS[0], cap: int = SWEEP_CAP,
                  reps: int = 3, iters: int = 20, device=None) -> dict:
    """Time every candidate launch parameter of both kernels at one
    (n_rows, cap) shape through the wrappers' override keyword, each
    candidate held against the plain version first (a difference raises).
    A candidate's time is the least over `reps` of the mean of `iters`
    L2-cold launches (mean_launch_s); the per-kernel winner is the least
    time."""
    from ..device import resolve_device
    from ..native import score_update as su
    from ..native import vmem_gather as vg
    from ..ops.state import SimParams

    dev = resolve_device(device)
    t, src, fmd, slow, scales = _inputs(n_rows, cap, dev)
    params = SimParams(n=n_rows, capacity=cap, slow_weight=-10.0)
    want_g = vg.vmem_gather_ref(t, src)
    want_s = su.score_update_ref(fmd, slow, scales, params)

    def check_gather(got, b):
        if not torch.equal(got, want_g):
            raise RuntimeError(f"vmem_gather blocks_per_sm={b} differs from "
                               f"the plain version at {n_rows}x{cap}")

    def check_score(got, th):
        for i, what in ((0, "fmd"), (1, "slow")):
            if not torch.equal(got[i], want_s[i]):
                raise RuntimeError(f"score_update threads={th}: {what} "
                                   f"differs at {n_rows}x{cap}")
        if got[2] is None:                  # the decay-only form
            return
        if not torch.allclose(got[2], want_s[2], rtol=SCORE_RTOL,
                              atol=SCORE_ATOL):
            raise RuntimeError(f"score_update threads={th}: score outside "
                               f"rtol {SCORE_RTOL} / atol {SCORE_ATOL} at "
                               f"{n_rows}x{cap}")

    gather_bytes = (2 * src.numel() + t.numel()) * 4
    score_bytes = fmd.numel() * 4 * 5 + scales.numel() * 4
    decay_bytes = fmd.numel() * 4 * 4 + scales.numel() * 4
    sweeps = {
        "vmem_gather": ("blocks_per_sm", vg.DEFAULT_BLOCKS_PER_SM,
                        gather_candidates(dev), gather_bytes,
                        lambda b: vg.vmem_gather(t, src, blocks_per_sm=b),
                        check_gather),
        "score_update": ("threads", su.DEFAULT_THREADS, THREAD_CANDIDATES,
                         score_bytes,
                         lambda th: su.score_update(fmd, slow, scales,
                                                    params, threads=th),
                         check_score),
        "score_update_decay_only": (
            "threads", su.DEFAULT_THREADS, THREAD_CANDIDATES, decay_bytes,
            lambda th: su.score_update(fmd, slow, scales, params,
                                       threads=th, with_score=False),
            check_score),
    }
    out: dict = {"n_rows": n_rows, "cap": cap,
                 "interpret": dev.type != "cuda", "device": str(dev),
                 "kernels": {}}
    for name, (param, default, cands, nbytes, call, check) in sweeps.items():
        walls: dict = {}
        for v in cands:
            check(call(v), v)
            walls[v] = min(
                mean_launch_s(lambda: call(v), iters, dev)  # noqa: B023
                for _ in range(max(reps, 1)))
        best = min(walls, key=walls.get)
        entry = {"param": param, "default": default,
                 "candidates": {str(v): w for v, w in walls.items()},
                 f"best_{param}": best, "best_wall_s": walls[best],
                 "default_wall_s": walls[default], "bytes": nbytes}
        if dev.type == "cuda":
            entry["bound_s"] = nbytes / HBM_BYTES_PER_S
            entry["best_share"] = entry["bound_s"] / walls[best]
        out["kernels"][name] = entry
    return out


def tuned_table(sweeps: list[dict]) -> dict:
    """One launch parameter per kernel over several swept shapes: the
    candidate with the least sum over shapes of its time over that shape's
    best time (each shape weighs the same, whatever its size). A row named
    in TUNES picks its target's entry in place of the target's own row."""
    kernels = sweeps[0]["kernels"]
    rows = {name: name for name in kernels if name not in TUNES}
    rows.update({TUNES[name]: name for name in kernels if name in TUNES})
    table = {}
    for name, row in rows.items():
        entries = [s["kernels"][row] for s in sweeps]
        param = entries[0]["param"]

        def cost(v):
            return sum(e["candidates"][v] / e["best_wall_s"] for e in entries)

        best = min(entries[0]["candidates"], key=cost)
        table[name] = {param: int(best)}
    return table


def _launch_log(thunk, device) -> dict:
    """{device kernel or copy: count} of one call, from torch.profiler's
    CUDA capture after a traced warm-up call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            thunk()
            torch.cuda.synchronize(device)
            prof.step()
    log: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            log[ev.name] = log.get(ev.name, 0) + 1
    return log


def packed_state_ab(n: int = 100_000, connect_to: int = 10, reps: int = 3,
                    payload_bytes: int = 15_000, warm_hb: int = 10,
                    device=None) -> dict:
    """SimParams.packed_state A/B at one width: timed exact publish walls
    off / on, whether the flag changed the program, and the recorded
    verdict, which never flips the default from a measurement. The
    program is the dispatch route (receiver-side or not) and the op log of
    one publish (`op_log`: every dispatched aten op and kernel launch),
    exact on any device. On the card the profiler's launch log of each
    publish is reported beside it (`launch_log_identical`), with a second
    capture of the unpacked publish (`launch_log_repeatable`): the capture
    can miss records, so the log is not what the verdict reads."""
    from ..config.topology import Topology, TopoParams
    from ..device import resolve_device
    from ..ops.disseminate import answer_tables, disseminate, edge_tables
    from ..ops.graph import build_connection_graph
    from ..ops.heartbeat import run_heartbeats
    from ..ops.pull import exceeds_budget
    from ..ops.state import SimParams, graph_arrays, init_state
    from .profiling import op_log

    dev = resolve_device(device)
    topo = Topology.build(TopoParams(
        network_size=n, anchor_stages=5, min_bandwidth=50,
        max_bandwidth=150, min_latency=40, max_latency=130,
        msg_size_bytes=payload_bytes))
    graph = build_connection_graph(n, connect_to, seed=0)
    params = SimParams(n=n, capacity=graph.capacity, serialize_answers=True)
    a = graph_arrays(graph, dev)
    stage, lat, bw = (torch.as_tensor(x, device=dev) for x in (
        topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit))
    lat_edge, _ = edge_tables(stage, lat, a["conns"], a["rev"])
    ans = answer_tables(lat_edge, a["conns"])
    state = init_state(params, seed=0, device=dev)
    state = run_heartbeats(state, a["conns"], a["rev"], a["out_mask"],
                           params, warm_hb)              # form the mesh
    t0 = float(state.t_ms)

    def publish(p):
        res, _ = disseminate(
            state, a["conns"], a["rev"], stage, lat, bw, publisher=4,
            t0_ms=t0, params=p, payload_bytes=payload_bytes,
            lat_edge=lat_edge, ans_tables=ans)
        return res.delay_ms

    recv_side = exceeds_budget(torch.float32, a["conns"].shape, 1)
    out: dict = {"n_peers": n, "delivery_mode": "exact",
                 "receiver_side": recv_side}
    delays, ops, launch_logs = {}, {}, {}
    for key, p in (("off", params),
                   ("on", dataclasses.replace(params, packed_state=True))):
        delays[key] = publish(p)                           # warm
        out[f"publish_{key}_s"] = _min_wall(
            lambda: publish(p), reps, dev)  # noqa: B023
        ops[key] = op_log(lambda: publish(p), dev)  # noqa: B023
        if dev.type == "cuda":
            launch_logs[key] = _launch_log(
                lambda: publish(p), dev)  # noqa: B023
    same_ops = ops["off"] == ops["on"]
    identical = (not recv_side) and same_ops
    out["op_log_identical"] = same_ops
    out["launch_log_identical"] = out["launch_log_repeatable"] = None
    if launch_logs:
        again = _launch_log(lambda: publish(params), dev)
        out["launch_log_identical"] = launch_logs["off"] == launch_logs["on"]
        out["launch_log_repeatable"] = launch_logs["off"] == again
        out["launch_records"] = [sum(launch_logs["off"].values()),
                                 sum(again.values()),
                                 sum(launch_logs["on"].values())]
    out["program_identical"] = identical
    out["delays_identical"] = bool(torch.equal(delays["off"], delays["on"]))
    out["packed_over_unpacked"] = (out["publish_off_s"]
                                   / max(out["publish_on_s"], 1e-12))
    out["verdict"] = (
        "keep-default-off: exact mode is the model of record and the bf16 "
        "per-edge tables break its bit guarantee, so packed_state can only "
        "be a bounded-mode knob; "
        + ("the flag is DEAD at this rung (receiver-side formulation not "
           "dispatched below the row-gather budget on one device) — the "
           "walls differ only by host noise"
           if identical else
           "the flag is live at this rung (receiver-side formulation "
           "dispatched); the measured ratio above is the bounded-path "
           "trade, not grounds to flip the exact-mode default"))
    return out


def _rows(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x.strip()]


def run(argv=None) -> dict:
    """CLI body (`microbench` subcommand): assemble the strict-JSON
    artifact, optionally install the tuned launch table."""
    from ..device import resolve_device
    from .summarize import sanitize_nonfinite

    ap = argparse.ArgumentParser(
        prog="microbench",
        description="per-entry-point rooflines + kernel launch tuning")
    ap.add_argument("--out", default="", help="write the artifact here "
                    "(default: print one JSON line)")
    ap.add_argument("--only", default="", metavar="PREFIX",
                    help="restrict rooflines to contracts with this name "
                    "prefix")
    ap.add_argument("--no-retraces", action="store_true",
                    help="skip the per-contract retrace measurement")
    ap.add_argument("--no-rooflines", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--no-packed", action="store_true")
    ap.add_argument("--install", action="store_true",
                    help="write the sweep winners to native/tuned.json "
                    "(DST_TUNED_JSON overrides the path)")
    ap.add_argument("--sweep-rows", type=_rows,
                    default=list(SWEEP_ROWS), metavar="N[,N...]",
                    help="rows of each swept shape (default: the main "
                    "paths' 100000,670000,1000000)")
    ap.add_argument("--sweep-cap", type=int, default=SWEEP_CAP)
    ap.add_argument("--packed-n", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "versions of the kernels)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(str(exc))

    out: dict = {"metric": "microbench", "device": str(dev)}
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
    if not args.no_rooflines:
        out["rooflines"] = registry_rooflines(
            args.only or None, with_retraces=not args.no_retraces,
            reps=args.reps, device=dev)
    if not args.no_sweep:
        sweeps = [sweep_kernels(rows, args.sweep_cap, args.reps, device=dev)
                  for rows in args.sweep_rows]
        out["kernel_sweep"] = sweeps
        tuned = tuned_table(sweeps)
        out["tuned"] = tuned
        if args.install:
            from ..native import tuned as _tuned

            with open(_tuned.tuned_path(), "w") as fh:
                json.dump(tuned, fh, indent=1, sort_keys=True,
                          allow_nan=False)
                fh.write("\n")
            # the wrappers read the table through this cache
            _tuned.invalidate_cache()
            out["tuned_installed"] = _tuned.tuned_path()
    if not args.no_packed:
        out["packed_state_ab"] = packed_state_ab(args.packed_n,
                                                 reps=args.reps, device=dev)
    out = sanitize_nonfinite(out)
    text = json.dumps(out, allow_nan=False)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    else:
        print(text)
    return out
