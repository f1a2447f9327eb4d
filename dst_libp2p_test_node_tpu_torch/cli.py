"""Command line of the port: the reference's `run` experiment, its role
workloads (`kad`, `connmanager`, `regression`, `servicedisco`), the
resident node service (`serve`, driven by `inject`), the adversarial
campaign (`attack`), the defense Pareto sweep (`pareto`), the protocol
arena (`arena`), the conformance gate (`conform`), the flight-recorder
export (`trace`), the contract lint (`lint`), the microbench and launch
tuning harness (`microbench`) and the `topogen` and `summarize` tools, on
one GPU.

  python -m dst_libp2p_test_node_tpu_torch run <runs> <nodes> <message_size> \\
      <num_fragment> <num_publishers> <min_bandwidth> <max_bandwidth> \\
      <min_latency> <max_latency> <anchor_stages> <packet_loss> \\
      <publisher_id> <publisher_rotation> <inter_message_delay> \\
      [--delivery-mode exact|bounded] [--device cpu] [flags]

The 14 positionals and the flags are the reference's (shadow/run.sh:23-38
order, dst_libp2p_test_node_tpu/cli.py cmd_run), plus `--device`. It writes
latencies<i> and shadowlog<i> and prints the per-run summaries. The
delivery mode defaults to exact (serialized gossip answers, the model of
record), as in the reference. A nonzero <packet_loss> (or a lossy --gml)
runs the loss model --loss-mode names (tcp, the default, or message).
--use-mix relays every publish through the mix network (--num-mix,
--mix-d). Beside the outputs it writes the topology artifacts
network_topology.gml and shadow.yaml, as the reference does (not under
--gml, whose file already exists, nor under --resume). --checkpoint FILE
snapshots the run after every --checkpoint-every messages and after the
last; --resume FILE continues such a snapshot on --device, with the same
positionals and flags (runs must be 1 for both).

The role commands take the reference's flags and env surface plus
`--device`; their summaries and the files of --log, --trace and
--latencies are the reference CLI's byte for byte, and a wall line of the
port's own ends the output.

  python -m dst_libp2p_test_node_tpu_torch serve [--device cpu] \
      [--control-port P] [--metrics-port P] [--checkpoint F [--resume]] ...
  python -m dst_libp2p_test_node_tpu_torch inject host:port ... -s SIZE \
      -m MESSAGES -d DELAY_S [--burst K] [--peer-selection id|rotation]

`serve` hosts the whole simulated network (the PEERS / CONNECTTO /
FRAGMENTS / MUXER / GOSSIPSUB_* env surface; TOPICS=a,b,... for several
topics) and answers the reference node's HTTP surface: POST /publish and
GET /health, /ready, /service, /telemetry on the control port (8645), GET
/metrics on the metrics port (8008); port 0 picks a free port. SIGTERM
drains, flushes the final --checkpoint and exits 0; --resume restarts from
that checkpoint. `topogen` writes network_topology.gml and shadow.yaml
(the reference topogen's flags, or run.sh's 13 positionals); `summarize`
prints the awk summary of a latencies file.

  python -m dst_libp2p_test_node_tpu_torch attack --scenario S -n PEERS \
      --fractions 0,0.1 --seeds 0,1 [--recovery-heartbeats R --evict --px \
      --redial] [--adaptive] [--crash-frac F --crash-window A:B ...] \
      [--dht-eclipse --dht-poison --dht-cluster --dht-heal-hb H] \
      [--json F] [--metrics-out F] [--device cpu]
  python -m dst_libp2p_test_node_tpu_torch pareto [--scenario S] \
      [--degree-grid DL:D:DH,...] [--weight-grid W,...] [--json F] \
      [--device cpu]

`attack` runs one scenario over a fraction x seed grid, with the fault
schedule, the adaptive attacker and the DHT adversary when their flags
arm them, and prints the reference's campaign report; --json writes the
result as strict JSON and --metrics-out the dst_testnode_attack_*
Prometheus text, both the reference CLI's bytes apart from wall times.
`pareto` races a grid of defense knobs against the adaptive attacker and
prints the reference's Pareto report (--json: its artifact).

  python -m dst_libp2p_test_node_tpu_torch arena \
      [--scenarios benign,sybil_graft_flood] [-n PEERS] [--fraction F] \
      [--seeds 0,1] [--lazy-degree K] [--json F] [--device cpu]

`arena` races GossipSub against the episub tree (the adaptive attacker as
referee) and prints the reference's win matrix (--json: its artifact).
`attack`, `pareto` and `arena` take --trial-groups N: the attacked seeds
run on a trial grid, one rank process per GPU (0: one per visible device;
with --device cpu, N CPU ranks); `attack --mesh` (the peer mesh) exits
with an error naming its slice.

  python -m dst_libp2p_test_node_tpu_torch conform [--scenario S ...] \
      [--seeds 0 1] [--fuzz N] [--out F] [--device cpu]
  python -m dst_libp2p_test_node_tpu_torch trace [-n PEERS] \
      [--heartbeats H] [--warmup-hb W] [--out DIR] [--profile-dir DIR] \
      [--device cpu]

  python -m dst_libp2p_test_node_tpu_torch lint [paths] [--no-ast] \
      [--no-jaxpr] [--checkify] [--only PREFIX] [--out F] \
      [--format json|github] [--device cpu]
  python -m dst_libp2p_test_node_tpu_torch microbench [--only PREFIX] \
      [--no-rooflines] [--no-sweep] [--no-packed] [--install] \
      [--sweep-rows N,...] [--packed-n N] [--out F] [--device cpu]

`lint` runs the AST lint (GA-A005) over the port and chip_smoke.py and
every registered entry point's contract (analysis/registry.py) on the
device, and prints the reference's strict-JSON report; it exits 0 iff
clean. --sharding and the --predict-rung / --rung-* flags exit with an
error naming the peer mesh (A13, second half). `microbench` prints (or writes with
--out) the rooflines of the registry, the kernels' launch-parameter sweep
and the packed_state A/B; --install writes the sweep's winners to the
tuning table (native/tuned.py).

`conform` walks the engine's rounds beside the pure-numpy GossipSub v1.1
model and prints the strict-JSON conformance certificate (--out writes
it); it exits 0 iff the certificate is clean. `trace` records a window of
heartbeats and writes trace.perfetto.json, rounds.npz and rounds.csv into
--out, and with --profile-dir a torch.profiler capture of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .config.env import env_float, env_str, gossipsub_params_from_env
from .config.topology import Topology, TopoParams

# run.sh positional order (run.sh:23-38)
RUN_SH_PARAMS = [
    "runs", "nodes", "msg_size", "num_frag", "num_publishers",
    "min_bandwidth", "max_bandwidth", "min_latency", "max_latency",
    "anchor_stages", "packet_loss", "publisher_id", "publisher_rotation",
    "inter_message_delay_ms",
]
# the 13 positionals run.sh hands to topogen (run.sh:49-50), in its order
TOPOGEN_POSITIONALS = [
    "nodes", "min_bandwidth", "max_bandwidth", "min_latency", "max_latency",
    "anchor_stages", "packet_loss", "msg_size", "num_frag", "num_publishers",
    "publisher_id", "publisher_rotation", "inter_message_delay_ms",
]


def _topo_flags(p: argparse.ArgumentParser) -> None:
    """The reference topogen's flag surface (topogen.py:13-36)."""
    p.add_argument("-n", "--network-size", type=int, default=100)
    p.add_argument("-bl", "--min-bandwidth", type=int, default=50)
    p.add_argument("-bh", "--max-bandwidth", type=int, default=50)
    p.add_argument("-ll", "--min-latency", type=int, default=100)
    p.add_argument("-lh", "--max-latency", type=int, default=100)
    p.add_argument("-st", "--anchor-stages", type=int, default=1)
    p.add_argument("-l", "--packet-loss", type=float, default=0.0)
    p.add_argument("-s", "--msg-size-bytes", type=int, default=1500)
    p.add_argument("-f", "--num-frags", type=int, choices=range(1, 10),
                   default=1)
    p.add_argument("-m", "--messages", type=int, default=10)
    p.add_argument("-d", "--delay-seconds", type=float, default=0.1)
    p.add_argument(
        "-mx", "--muxer", choices=["mplex", "yamux", "quic"], default="yamux"
    )


def _params_from_flags(a) -> TopoParams:
    return TopoParams(
        network_size=a.network_size,
        min_bandwidth=a.min_bandwidth,
        max_bandwidth=a.max_bandwidth,
        min_latency=a.min_latency,
        max_latency=a.max_latency,
        anchor_stages=a.anchor_stages,
        packet_loss=a.packet_loss,
        msg_size_bytes=a.msg_size_bytes,
        num_frags=a.num_frags,
        messages=a.messages,
        delay_seconds=a.delay_seconds,
        muxer=a.muxer,
    )


def _topo_from_fields(m: dict, muxer: str = "yamux") -> TopoParams:
    return TopoParams(
        network_size=int(m["nodes"]),
        min_bandwidth=int(m["min_bandwidth"]),
        max_bandwidth=int(m["max_bandwidth"]),
        min_latency=int(m["min_latency"]),
        max_latency=int(m["max_latency"]),
        anchor_stages=int(m["anchor_stages"]),
        packet_loss=float(m["packet_loss"]),
        msg_size_bytes=int(m["msg_size"]),
        num_frags=int(m["num_frag"]),
        messages=int(m["num_publishers"]),
        delay_seconds=float(m["inter_message_delay_ms"]) / 1000.0,
        muxer=muxer,
    )


def _run_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="run",
        usage="run <runs> <nodes> <message_size> <num_fragment> "
        "<num_publishers> <min_bandwidth> <max_bandwidth> <min_latency> "
        "<max_latency> <anchor_stages> <packet_loss> <publisher_id> "
        "<publisher_rotation> <inter_message_delay> [--delivery-mode "
        "exact|bounded] [--device cpu] [--seed N] [--warmup-s S] ...",
    )
    for name in RUN_SH_PARAMS:
        p.add_argument(name)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-s", type=float, default=500.0)
    p.add_argument("--connect-to", type=int, default=10)
    p.add_argument("--muxer", choices=["mplex", "yamux", "quic"],
                   default="yamux")
    p.add_argument("--no-gossip", action="store_true")
    p.add_argument("--churn", type=float, default=0.0,
                   help="per-heartbeat down-probability (failure injection)")
    p.add_argument("--use-mix", action="store_true",
                   help="route publishes through the mix network")
    p.add_argument("--num-mix", type=int, default=0, help="NUMMIX")
    p.add_argument("--mix-d", type=int, default=4, help="MIXD")
    p.add_argument("--out-prefix", default="")
    p.add_argument("--stats-json", action="store_true",
                   help="also write stats<i>.json next to latencies<i>")
    p.add_argument("--checkpoint", default=None,
                   help="snapshot the experiment to this .npz during the "
                   "run (requires runs == 1)")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="messages between snapshots")
    p.add_argument("--resume", default=None,
                   help="resume from a --checkpoint file and finish its "
                   "schedule (requires runs == 1, same config)")
    p.add_argument("--gml", default=None,
                   help="ingest an existing network_topology.gml (needs "
                   "networkx)")
    p.add_argument("--msgid-mode", choices=["nim", "go"], default="nim")
    p.add_argument("--loss-mode", choices=["tcp", "message"], default="tcp")
    p.add_argument("--delivery-mode", choices=["exact", "bounded"],
                   default="exact",
                   help="answered-IWANT serialization fidelity: exact "
                   "(the model of record) or bounded (unserialized arrival "
                   "times with an error bar)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                   "versions of the kernels)")
    return p


def cmd_run(argv: list[str]) -> int:
    p = _run_parser()
    a = p.parse_args(argv)
    if (a.checkpoint or a.resume) and int(a.runs) != 1:
        # per-run states would overwrite one checkpoint file
        p.error("--checkpoint/--resume require runs == 1")
    if a.resume and a.gml:
        # a resumed run continues on the checkpoint's own topology
        p.error("--resume restores the checkpoint's topology; drop --gml")
    if a.use_mix:
        # a publisher that is itself a mix node is left out of its own
        # relay path, so rotation or a mix-range publisher_id needs a spare
        need = a.mix_d + (
            1 if (int(a.publisher_rotation) or int(a.publisher_id) < a.num_mix)
            else 0
        )
        if a.num_mix < need:
            p.error(f"--use-mix requires --num-mix >= {need} here "
                    f"(mix-d={a.mix_d}, publisher inside mix range or "
                    f"rotation on), got {a.num_mix}")
    from .device import resolve_device
    from .runtime.simulator import ExperimentConfig, Simulator
    from .runtime.summarize import report, sanitize_nonfinite

    try:
        device = resolve_device(a.device)
    except RuntimeError as exc:
        p.error(str(exc))
    topo = _topo_from_fields(vars(a), muxer=a.muxer)
    if a.gml:
        t = Topology.from_gml(a.gml, network_size=topo.network_size,
                              params=topo)
        topo = t.params
    elif a.resume:
        # the checkpoint holds its topology; the experiment dir's
        # artifacts are left as they are
        t = None
    else:
        t = Topology.build(topo)
        t.write_gml(a.out_prefix + "network_topology.gml")
        t.write_shadow_yaml(a.out_prefix + "shadow.yaml")

    large = topo.msg_size_bytes >= 1000
    for i in range(1, int(a.runs) + 1):
        print(f"Running for turn {i}")
        cfg = ExperimentConfig(
            topo=topo,
            connect_to=a.connect_to,
            gossipsub=gossipsub_params_from_env(),
            publisher_id=int(a.publisher_id),
            publisher_rotation=bool(int(a.publisher_rotation)),
            warmup_s=a.warmup_s,
            seed=a.seed + i - 1,
            with_gossip=not a.no_gossip,
            churn_down_per_hb=a.churn,
            churn_up_per_hb=a.churn / 2 if a.churn else 0.0,
            uses_mix=a.use_mix,
            num_mix=a.num_mix,
            mix_d=a.mix_d,
            msgid_mode=a.msgid_mode,
            loss_mode=a.loss_mode,
            serialize_answers=(a.delivery_mode == "exact"),
        )
        t0 = time.time()
        if a.resume:
            from .runtime.checkpoint import load_checkpoint

            sim = load_checkpoint(a.resume, device=device)
            if sim.cfg != cfg:
                p.error("--resume checkpoint was created with a different "
                        "configuration than these arguments; re-run with "
                        "the original parameters")
        else:
            sim = Simulator(cfg, topology=t, device=device)
        sim.run(checkpoint_path=a.checkpoint,
                checkpoint_every=a.checkpoint_every)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        wall = time.time() - t0
        n_lines = sim.write_latencies(f"{a.out_prefix}latencies{i}")
        sim.write_shadowlog(f"{a.out_prefix}shadowlog{i}")
        s = sim.summary(large)
        print(f"Summary for turn {i}")
        print(report(s, large=large), end="")
        print(sim.bandwidth_report(), end="")
        print(f"[torch backend device={device}] wall={wall:.2f}s "
              f"peers*rounds/s={sim.peer_rounds_per_sec(wall):.0f} "
              f"lines={n_lines}")
        if a.stats_json:
            delays = np.concatenate(
                [r.delays_ms[r.received] for r in sim.records])
            with open(f"{a.out_prefix}stats{i}.json", "w") as f:
                json.dump(sanitize_nonfinite({
                    "network_size": s.network_size,
                    "coverage": s.coverage(),
                    "max_latency_ms": s.max_latency_ms,
                    "avg_latency_ms": s.avg_latency_ms,
                    "avg_max_latency_ms": s.avg_max_latency_ms,
                    "p50_ms": float(np.percentile(delays, 50)),
                    "p99_ms": float(np.percentile(delays, 99)),
                    "converged": all(r.converged for r in sim.records),
                    "answer_wait_max_ms": max(
                        r.answer_wait_max_ms for r in sim.records),
                    "delivery_mode": a.delivery_mode,
                    "refine_passes": [r.refine_passes for r in sim.records],
                    "device": str(device),
                    "wall_s": wall,
                    "peer_rounds_per_sec": sim.peer_rounds_per_sec(wall),
                }), f, indent=2, allow_nan=False)
    return 0


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                   "versions of the kernels)")


def _resolve(p: argparse.ArgumentParser, device):
    from .device import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as exc:
        p.error(str(exc))


def _trial_grid(p: argparse.ArgumentParser, groups, device):
    """--trial-groups N as a trial grid (None without the flag): N groups
    over the visible CUDA devices, 0 one per device (N must divide the
    count); on --device cpu, N CPU ranks (0: one)."""
    if groups is None:
        return None
    from .parallel.sharding import check_trial_grid, make_trial_mesh

    try:
        if device.type == "cpu":
            return make_trial_mesh(devices=["cpu"] * max(groups, 1))
        return check_trial_grid(make_trial_mesh(groups or None))
    except (ValueError, NotImplementedError) as e:
        p.error(str(e))


def _wall_line(device, t0: float, extra: str = "") -> str:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    return (f"[torch backend device={device}] wall={time.time() - t0:.2f}s"
            + extra)


def _write_lines(path: str, lines: list[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cmd_kad(argv: list[str]) -> int:
    """Role-based kad-dht workload (kad-dht/main.nim:15-72): bootstrap
    anchors, RoleNormal warm-up and the RoleProbe lookup loop, batched."""
    p = argparse.ArgumentParser(prog="kad")
    p.add_argument("-n", "--nodes", type=int, default=None,
                   help="defaults to PEERS env")
    p.add_argument("--bootstraps", type=int, default=None)
    p.add_argument("--probes", type=int, default=None)
    p.add_argument("--discovery", choices=["kad-dht", "extended"],
                   default=None)
    p.add_argument("--duration-s", type=float, default=60.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log", default=None, help="write node log lines here")
    _device_arg(p)
    a = p.parse_args(argv)

    from .runtime.kad_runtime import KadSimulator, config_from_env

    cfg = config_from_env()
    if a.nodes is not None:
        cfg.network_size = a.nodes
    if a.bootstraps is not None:
        cfg.n_bootstrap = a.bootstraps
    if a.probes is not None:
        cfg.n_probe = a.probes
    if a.discovery is not None:
        cfg.discovery = a.discovery
    if a.seed is not None:
        cfg.seed = a.seed
    cfg.probe_duration_s = a.duration_s
    cfg.validate()
    device = _resolve(p, a.device)
    t0 = time.time()
    sim = KadSimulator(cfg, device=device)
    summary = sim.run()
    wall = _wall_line(device, t0, f" lookups={len(sim.lookups)}")
    if a.log:
        _write_lines(a.log, sim.lines)
    print(summary.report())
    print(wall)
    return 0


def cmd_connmanager(argv: list[str]) -> int:
    """Hub-and-spoke connection-manager stress (connmanager/main.nim):
    watermark trimming and reconnect strategies, driven by the WATERMARK_*
    / RECONNECT env surface with flag overrides."""
    p = argparse.ArgumentParser(prog="connmanager")
    p.add_argument("--duration-s", type=int, default=None)
    p.add_argument("--trace", default=None,
                   help="write the per-tick hub connection counts (CSV)")
    _device_arg(p)
    a = p.parse_args(argv)

    from .ops.connmanager import config_from_env, run_connmanager

    cfg = config_from_env()
    if a.duration_s is not None:
        cfg.duration_s = a.duration_s
    device = _resolve(p, a.device)
    t0 = time.time()
    summary, _ = run_connmanager(cfg, device=device)
    wall = _wall_line(device, t0, f" ticks={len(summary.trace)}")
    if a.trace:
        np.savetxt(a.trace, summary.trace, fmt="%d", delimiter=",")
    print(summary.report())
    print(wall)
    return 0


def cmd_regression(argv: list[str]) -> int:
    """Regression workload (regression/main.nim): GossipSub mesh formed via
    kad-dht bootstrap, mesh ping probes and the standard latency output."""
    p = argparse.ArgumentParser(prog="regression")
    p.add_argument("-n", "--nodes", type=int, default=None)
    p.add_argument("--messages", type=int, default=None)
    p.add_argument("--msg-size", type=int, default=None)
    p.add_argument("--log", default=None)
    p.add_argument("--latencies", default=None,
                   help="write awk-compatible latencies file here")
    _device_arg(p)
    a = p.parse_args(argv)

    from .runtime.logemit import LatenciesWriter
    from .runtime.regression_runtime import RegressionSimulator
    from .runtime.regression_runtime import config_from_env as regression_cfg

    cfg = regression_cfg()
    if a.nodes is not None:
        cfg.network_size = a.nodes
    if a.messages is not None:
        cfg.messages = a.messages
    if a.msg_size is not None:
        cfg.msg_size = a.msg_size
    cfg.validate()
    device = _resolve(p, a.device)
    t0 = time.time()
    sim = RegressionSimulator(cfg, device=device)
    summary = sim.run()
    wall = _wall_line(device, t0)
    if a.log:
        _write_lines(a.log, sim.lines)
    if a.latencies:
        w = LatenciesWriter()
        for rec in sim.records():
            w.add_message(rec.msg_id, rec.receivers, rec.delays_ms_int)
        w.write(a.latencies)
    print(summary.report())
    print(wall)
    return 0


def cmd_servicedisco(argv: list[str]) -> int:
    """Service-discovery workload (service-discovery/main.nim):
    advertisers, discoverers and hybrids over the DHT, env-driven with flag
    overrides."""
    p = argparse.ArgumentParser(prog="servicedisco")
    p.add_argument("-n", "--nodes", type=int, default=None)
    p.add_argument("--duration-s", type=int, default=None)
    p.add_argument("--services", default=None,
                   help="comma-separated (ADVERTISE_SERVICES)")
    p.add_argument("--log", default=None)
    _device_arg(p)
    a = p.parse_args(argv)

    from .runtime.sd_runtime import SDSimulator, config_from_env

    cfg = config_from_env()
    if a.nodes is not None:
        cfg.network_size = a.nodes
    if a.duration_s is not None:
        cfg.duration_s = a.duration_s
    if a.services:
        cfg.services = [s.strip() for s in a.services.split(",")
                        if s.strip()]
    cfg.validate()
    device = _resolve(p, a.device)
    t0 = time.time()
    sim = SDSimulator(cfg, device=device)
    summary = sim.run()
    wall = _wall_line(device, t0)
    if a.log:
        _write_lines(a.log, sim.lines)
    print(summary.report())
    print(wall)
    return 0


def cmd_topogen(argv: list[str]) -> int:
    """network_topology.gml + shadow.yaml from the reference topogen's
    flags or run.sh's 13 positionals (the reference's two halves are out
    of sync, run.sh:49-50; both are accepted)."""
    if argv and not argv[0].startswith("-"):
        if len(argv) != 13:
            print(
                f"topogen: expected 13 positional args "
                f"({' '.join(TOPOGEN_POSITIONALS)}) or flag form, got "
                f"{len(argv)}",
                file=sys.stderr,
            )
            return 2
        topo = _topo_from_fields(dict(zip(TOPOGEN_POSITIONALS, argv)))
    else:
        p = argparse.ArgumentParser(prog="topogen")
        _topo_flags(p)
        topo = _params_from_flags(p.parse_args(argv))
    t = Topology.build(topo)
    t.write_gml()
    t.write_shadow_yaml()
    print(f"wrote network_topology.gml + shadow.yaml ({topo.network_size} "
          f"peers, {topo.anchor_stages} stages)")
    return 0


def cmd_summarize(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="summarize")
    p.add_argument("path")
    p.add_argument("--large", action="store_true")
    a = p.parse_args(argv)
    from .runtime.summarize import report, summarize_file

    print(report(summarize_file(a.path, large=a.large), large=a.large),
          end="")
    return 0


def cmd_serve(argv: list[str]) -> int:
    """Run as a long-lived node service (the reference's steady-state node:
    HTTP /publish + /health + /ready on :8645, Prometheus on :8008),
    hosting the whole simulated network on the device and exposing the
    env-selected peer's view (getPeerDetails, env.nim:13-36)."""
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--control-port", type=int, default=None)
    p.add_argument("--metrics-port", type=int, default=None)
    p.add_argument("--time-scale", type=float, default=1.0,
                   help="simulated seconds advanced per wall second")
    p.add_argument("--tick-s", type=float, default=1.0)
    p.add_argument("--duration-s", type=float, default=None)
    p.add_argument("--warmup-s", type=float, default=15.0,
                   help="heartbeats run before serving (mesh stabilization, "
                   "main.nim:466-477)")
    p.add_argument("--store-metrics-dir", default=None)
    p.add_argument("--queue-depth", type=int, default=1024,
                   help="bounded admission queue; overflow answers 429")
    p.add_argument("--device-ms-budget", type=float, default=0.0,
                   help="reject once est. queued device ms exceeds this")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="default per-request sim-time deadline (0 = none)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="requests per service round (tenant round-robin)")
    p.add_argument("--dispatch-mode", default="batched",
                   choices=("batched", "sequential"),
                   help="batched = one publish_batch per same-shape group "
                   "of the round; sequential = one publish per request")
    p.add_argument("--dispatch-timeout-s", type=float, default=0.0)
    p.add_argument("--max-retries", type=int, default=1)
    p.add_argument("--retry-backoff-s", type=float, default=0.05)
    p.add_argument("--inject-failures", type=int, default=0,
                   help="force the first K dispatch attempts to fail (CI)")
    p.add_argument("--checkpoint", default=None,
                   help="service checkpoint path (periodic + final flush)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="flush every K service rounds (0 = final only)")
    p.add_argument("--drain-deadline-s", type=float, default=5.0)
    p.add_argument("--resume", action="store_true",
                   help="warm-restart from --checkpoint if it exists")
    _device_arg(p)
    a = p.parse_args(argv)

    from .config.env import (
        HTTP_CONTROL_PORT,
        PROMETHEUS_PORT,
        get_peer_details,
    )
    from .runtime.node_service import ServiceConfig, serve_forever
    from .runtime.simulator import ExperimentConfig, Simulator

    node = get_peer_details()
    node.validate()  # reject unknown muxer / connect_to >= peers at startup
    svc_cfg = ServiceConfig(
        max_queue_depth=a.queue_depth,
        device_ms_budget=a.device_ms_budget,
        default_deadline_ms=a.deadline_ms,
        max_batch=a.max_batch,
        dispatch_mode=a.dispatch_mode,
        dispatch_timeout_s=a.dispatch_timeout_s,
        max_retries=a.max_retries,
        retry_backoff_s=a.retry_backoff_s,
        inject_failures=a.inject_failures,
        checkpoint_path=a.checkpoint,
        checkpoint_every=a.checkpoint_every,
        drain_deadline_s=a.drain_deadline_s,
    )
    svc_cfg.validate()
    if a.resume and not a.checkpoint:
        p.error("--resume requires --checkpoint")
    device = _resolve(p, a.device)
    store_dir = a.store_metrics_dir
    if store_dir is None and node.in_shadow:
        store_dir = "."  # in-Shadow persistence default (env.nim:58-73)
    control = (a.control_port if a.control_port is not None
               else HTTP_CONTROL_PORT)
    metrics = (a.metrics_port if a.metrics_port is not None
               else PROMETHEUS_PORT)
    serve = dict(time_scale=a.time_scale, tick_s=a.tick_s,
                 duration_s=a.duration_s, store_metrics_dir=store_dir,
                 out=sys.stdout, service=svc_cfg, device=device)
    if a.resume and os.path.exists(a.checkpoint):
        # warm restart: the checkpoint carries sim + service state, so no
        # simulator is built or warmed here
        print(f"node service warm-restarting from {a.checkpoint}, "
              f"control :{control} metrics :{metrics} device {device}",
              flush=True)
        serve_forever(None, node, control_port=control,
                      metrics_port=metrics, resume_from=a.checkpoint,
                      **serve)
        return 0
    topo = TopoParams(
        network_size=node.network_size,
        muxer=node.muxer,
        num_frags=node.fragments,
    )
    topics = tuple(
        s.strip() for s in env_str("TOPICS", "").split(",") if s.strip())
    if len(topics) == 1:
        node.topic = topics[0]  # single custom topic, single-topic engine
    if len(topics) > 1:
        # multi-topic node: /publish routes by topic name (BASELINE config
        # 3 surface); SUBSCRIBE_FRACTION < 1 subscribes each peer per topic
        if node.uses_mix or node.mounts_mix:
            p.error("mix routing (USESMIX/MOUNTSMIX) is single-topic only; "
                    "drop TOPICS or the mix surface")
        from .runtime.multitopic import MultiTopicConfig, MultiTopicSimulator

        sim = MultiTopicSimulator(MultiTopicConfig(
            topo=topo,
            topics=topics,
            connect_to=node.connect_to,
            gossipsub=node.gossipsub,
            warmup_s=a.warmup_s,
            subscribe_fraction=env_float("SUBSCRIBE_FRACTION", 1.0),
            max_connections=node.max_connections,
            self_trigger=node.self_trigger,
        ), device=device)
    else:
        sim = Simulator(ExperimentConfig(
            topo=topo,
            connect_to=node.connect_to,
            gossipsub=node.gossipsub,
            warmup_s=a.warmup_s,
            self_trigger=node.self_trigger,
            max_connections=node.max_connections,
            uses_mix=node.uses_mix,
            num_mix=node.num_mix,
            mix_d=node.mix_d,
        ), device=device)
    sim.warmup()
    print(
        f"node service up: {node.network_size} peers simulated, node view "
        f"peer {node.my_id}, control :{control} metrics :{metrics} "
        f"device {device}", flush=True)
    serve_forever(sim, node, control_port=control, metrics_port=metrics,
                  **serve)
    return 0


def cmd_inject(argv: list[str]) -> int:
    """Publisher controller against running `serve` nodes: the
    traffic_sync surface (-s size, -m messages, -d delay,
    --peer-selection id|rotation)."""
    p = argparse.ArgumentParser(prog="inject")
    p.add_argument("targets", nargs="+",
                   help="node control endpoints (host[:port] or URL)")
    p.add_argument("-s", "--msg-size", type=int, default=1500)
    p.add_argument("-m", "--messages", type=int, default=10)
    p.add_argument("-d", "--delay-s", type=float, default=1.0)
    p.add_argument("--topic", default="test")
    p.add_argument("--peer-selection", choices=["id", "rotation"],
                   default="id")
    p.add_argument("--publisher-id", type=int, default=0)
    p.add_argument("--burst", type=int, default=1,
                   help="messages posted back-to-back before each delay: "
                   "gives a batched-dispatch service multi-request rounds")
    a = p.parse_args(argv)

    from .runtime.publisher import inject

    res = inject(
        a.targets, a.msg_size, a.messages, a.delay_s, topic=a.topic,
        peer_selection=a.peer_selection, publisher_id=a.publisher_id,
        burst=a.burst,
    )
    for r in res.replies:
        print(json.dumps(r, allow_nan=False))
    print(f"published ok={res.ok} failed={res.failed}")
    return 0 if res.failed == 0 else 1


def validate_attack_flags(
        scenario: str,
        *,
        mimic_margin: float | None = None,
        rotation_period_hb: int | None = None,
        dht_attack: bool = False,
        dht_heal_hb: int = -1,
        adaptive: bool = False,
        throttle_margin: float | None = None,
        px_poison_per_hb: int | None = None,
) -> None:
    """The reference's checks of `attack` scenario / flag combinations,
    made before any topology is built (ValueError names the flag)."""
    from .ops.adversary import ADAPTIVE_SCENARIOS

    if mimic_margin is not None and scenario != "slow_peer_mimicry":
        raise ValueError(
            f"--mimic-margin tunes the slow_peer_mimicry score setpoint; "
            f"scenario {scenario!r} never reads it — drop the flag or use "
            "--scenario slow_peer_mimicry")
    if rotation_period_hb is not None and scenario != "identity_rotation":
        raise ValueError(
            f"--rotation-period-hb sets the identity_rotation scrub cadence; "
            f"scenario {scenario!r} never reads it — drop the flag or use "
            "--scenario identity_rotation")
    if dht_attack and scenario == "cold_boot_join":
        raise ValueError(
            "--dht-eclipse/--dht-poison/--dht-cluster poison discovery "
            "state built during the attack window, but cold_boot_join "
            "replays the join race on a fresh topology with no pre-attack "
            "DHT to poison — drop the --dht-* flags or pick a scenario "
            "with an established mesh")
    if dht_heal_hb >= 0 and not dht_attack:
        raise ValueError(
            "--dht-heal-hb schedules the recovery round a DHT attack heals "
            "at, but no DHT attack is armed — add one of --dht-eclipse/"
            "--dht-poison/--dht-cluster")
    if adaptive and scenario not in ADAPTIVE_SCENARIOS:
        raise ValueError(
            f"--adaptive composes with the graft-flood family "
            f"{ADAPTIVE_SCENARIOS}, not scenario {scenario!r}: the spam "
            "scenarios have no backoff/mesh loop to adapt to, mimicry is "
            "already an adaptive policy, and rotation's identity scrubs "
            "erase the controller's own estimate")
    if throttle_margin is not None and not adaptive:
        raise ValueError("--throttle-margin tunes the adaptive duty cycle; "
                         "it needs --adaptive")
    if px_poison_per_hb is not None and not adaptive:
        raise ValueError("--px-poison-per-hb tunes the adaptive PX poison "
                         "rate; it needs --adaptive")




def cmd_attack(argv: list[str]) -> int:
    """Adversarial campaign driver: one scenario, a fraction x seed grid,
    the resilience report and optional JSON / Prometheus artifacts."""
    from .ops.adversary import SCENARIOS

    p = argparse.ArgumentParser(prog="attack")
    p.add_argument("--scenario", choices=SCENARIOS,
                   default="sybil_graft_flood")
    p.add_argument("-n", "--peers", type=int, default=256)
    p.add_argument("--fractions", default="0,0.1,0.2",
                   help="comma-separated attacker fractions in [0, 1); "
                   "include 0 for the in-sweep benign baseline")
    p.add_argument("--seeds", default="0",
                   help="comma-separated trial seeds (the Monte-Carlo axis)")
    p.add_argument("--messages", type=int, default=3)
    p.add_argument("--msg-size", type=int, default=2000)
    p.add_argument("--delay-s", type=float, default=1.0,
                   help="inter-message delay in the publish schedule")
    p.add_argument("--warmup-s", type=float, default=30.0)
    p.add_argument("--attack-heartbeats", type=int, default=20,
                   help="attacked mesh-maintenance rounds before publishing")
    p.add_argument("--connect-to", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="campaign seed: builds the shared connection graph")
    p.add_argument("--publisher-id", type=int, default=4)
    p.add_argument("--violation-penalty", type=float, default=1.0)
    p.add_argument("--mimic-margin", type=float, default=None,
                   help="slow_peer_mimicry only: pin the attacker score at "
                   "this fraction of the graylist threshold (0 < m < 1)")
    p.add_argument("--rotation-period-hb", type=int, default=None,
                   help="identity_rotation only: heartbeats between "
                   "identity scrubs (>= 2)")
    p.add_argument("--no-vmap", action="store_true",
                   help="run same-fraction trials one cell per seed")
    p.add_argument("--warm-start", action="store_true",
                   help="cross-publish warm-started fixpoints")
    p.add_argument("--checkpoint-dir", default=None,
                   help="snapshot each trial's post-window state here")
    p.add_argument("--recovery-heartbeats", type=int, default=0,
                   help="post-attack repair rounds before the publish "
                   "schedule (0 = no recovery window)")
    p.add_argument("--evict", action="store_true",
                   help="arm score-based mesh eviction in the recovery "
                   "window's heartbeats")
    p.add_argument("--eviction-threshold", type=float, default=-50.0,
                   help="PRUNE mesh members scoring below this (<= 0)")
    p.add_argument("--px", action="store_true",
                   help="peer exchange on PRUNE")
    p.add_argument("--px-count", type=int, default=6,
                   help="candidate ids carried per PRUNE")
    p.add_argument("--redial", action="store_true",
                   help="starved peers dial new connections")
    p.add_argument("--redial-patience", type=int, default=3)
    p.add_argument("--trial-timeout-s", type=float, default=0.0,
                   help="wall-clock ceiling per trial batch attempt "
                   "(0 = no timeout)")
    p.add_argument("--max-retries", type=int, default=2,
                   help="retry budget per trial cell before quarantine")
    p.add_argument("--retry-backoff-s", type=float, default=0.5,
                   help="base of the exponential retry backoff")
    p.add_argument("--inject-failures", type=int, default=0,
                   help="force the first N trial attempts to fail")
    p.add_argument("--json", default=None,
                   help="write the campaign result as strict JSON here")
    p.add_argument("--metrics-out", default=None,
                   help="write Prometheus text exposition of the "
                   "dst_testnode_attack_* series here")
    # the adaptive attacker controller (ops/adversary.AdaptivePolicy)
    p.add_argument("--adaptive", action="store_true",
                   help="arm the per-round adaptive attacker controller "
                   "(backoff-expiry regraft + PX sybil poison + recovery "
                   "slot race + score-aware duty cycle); graft-flood "
                   "scenarios only")
    p.add_argument("--throttle-margin", type=float, default=None,
                   help="adaptive duty-cycle setpoint as a fraction of the "
                   "graylist threshold (0 < m < 1); requires --adaptive")
    p.add_argument("--px-poison-per-hb", type=int, default=None,
                   help="sybil ids the adaptive attacker plants per victim "
                   "px_pool row per heartbeat; requires --adaptive")
    # fault injection (ops/faults.py): windows are A:B heartbeat rounds of
    # the attack window, half-open
    p.add_argument("--crash-frac", type=float, default=0.0,
                   help="fraction of non-publisher peers that crash for "
                   "--crash-window and restart with cold mesh/score state")
    p.add_argument("--crash-window", default="0:0", metavar="A:B",
                   help="heartbeat rounds [A, B) the crash cohort is dark")
    p.add_argument("--partition-frac", type=float, default=0.0,
                   help="fraction of peers cut onto the far side of a "
                   "two-component graph partition")
    p.add_argument("--partition-window", default="0:0", metavar="A:B",
                   help="heartbeat rounds [A, B) the partition is up")
    p.add_argument("--spike-frac", type=float, default=0.0,
                   help="fraction of peers whose uplink clocks take a "
                   "latency spike during --spike-window")
    p.add_argument("--spike-window", default="0:0", metavar="A:B",
                   help="heartbeat rounds [A, B) of the latency spike")
    p.add_argument("--spike-ms", type=float, default=0.0,
                   help="extra uplink serialization delay per spiked peer")
    # the DHT adversary (ops/dht_adversary.py): the recovery window's
    # re-dial path draws its candidates from the (attacked) DHT
    p.add_argument("--dht-eclipse", action="store_true",
                   help="lookup eclipse: attacker responders answer "
                   "FIND_NODE with sybil-only shortlists")
    p.add_argument("--dht-poison", action="store_true",
                   help="routing-table poisoning: sybil insert waves squat "
                   "honest bucket slots")
    p.add_argument("--dht-cluster", action="store_true",
                   help="sybil key clustering: mint attacker keys inside "
                   "the victim's keyspace prefix")
    p.add_argument("--dht-heal-hb", type=int, default=-1, metavar="HB",
                   help="recovery heartbeat at which the DHT heals (the "
                   "redial pool switches to honest lookups); -1 = never")
    p.add_argument("--dht-poison-per-peer", type=int, default=8,
                   help="sybil insert attempts per honest routing table")
    p.add_argument("--dht-cluster-prefix-bits", type=int, default=16,
                   help="shared victim-prefix bits of minted sybil keys")
    p.add_argument("--dht-evict-max-fails", type=int, default=1,
                   help="failed lookups a routing-table entry survives "
                   "before eviction (retry budget)")
    p.add_argument("--dht-evict-backoff-ms", type=float, default=0.0,
                   help="exponential backoff base between retries of a "
                   "failing routing-table entry")
    p.add_argument("--trial-groups", type=int, default=None, metavar="N",
                   help="deal each attacked fraction's seeds over N trial "
                   "groups, one rank process per GPU "
                   "(parallel/sharding.make_trial_mesh; N must divide the "
                   "device count; 0 = one group per visible device; with "
                   "--device cpu, N CPU ranks). Mutually exclusive with "
                   "--mesh")
    # the peer mesh (an error names the slice)
    later = p.add_argument_group("later slices")
    later.add_argument("--mesh", action="store_true")
    _device_arg(p)
    a = p.parse_args(argv)

    try:
        validate_attack_flags(
            a.scenario,
            mimic_margin=a.mimic_margin,
            rotation_period_hb=a.rotation_period_hb,
            dht_attack=(a.dht_eclipse or a.dht_poison or a.dht_cluster),
            dht_heal_hb=a.dht_heal_hb,
            adaptive=a.adaptive,
            throttle_margin=a.throttle_margin,
            px_poison_per_hb=a.px_poison_per_hb,
        )
    except ValueError as e:
        p.error(str(e))
    if a.mesh and a.trial_groups is not None:
        p.error("--trial-groups and --mesh are mutually exclusive "
                "(the trial grid already owns every device)")
    if a.mesh:
        from .parallel.sharding import PEER_MESH_SLICE

        p.error(f"--mesh is not ported yet: it comes with {PEER_MESH_SLICE}"
                " (ROADMAP A)")
    device = _resolve(p, a.device)
    trial_mesh = _trial_grid(p, a.trial_groups, device)

    def _window(spec: str, flag: str) -> tuple[int, int]:
        try:
            lo, hi = spec.split(":")
            return int(lo), int(hi)
        except ValueError:
            p.error(f"{flag} must be A:B heartbeat indices, got {spec!r}")

    from .ops.adversary import AdaptivePolicy, AdversaryParams
    from .ops.dht_adversary import DhtAdversaryParams
    from .ops.faults import FaultParams
    from .ops.repair import RepairParams
    from .runtime.campaign import (
        CampaignConfig, SupervisorConfig, attack_gossipsub, run_campaign)
    from .runtime.simulator import ExperimentConfig
    from .runtime.summarize import report_campaign

    fractions = tuple(float(s) for s in a.fractions.split(",") if s.strip())
    seeds = tuple(int(s) for s in a.seeds.split(",") if s.strip())
    adv_kw: dict = {}
    if a.mimic_margin is not None:
        adv_kw["mimic_margin"] = a.mimic_margin
    if a.rotation_period_hb is not None:
        adv_kw["rotation_period_hb"] = a.rotation_period_hb
    if a.adaptive:
        pol_kw: dict = {"enabled": True}
        if a.throttle_margin is not None:
            pol_kw["throttle_margin"] = a.throttle_margin
        if a.px_poison_per_hb is not None:
            pol_kw["px_poison_per_hb"] = a.px_poison_per_hb
        adv_kw["adaptive"] = AdaptivePolicy(**pol_kw)
    # eclipse needs a mesh-bound publish to have anything to eclipse
    gs = attack_gossipsub(flood_publish=(a.scenario != "eclipse_publisher"))
    cfg = CampaignConfig(
        scenario=a.scenario,
        fractions=fractions,
        seeds=seeds,
        experiment=ExperimentConfig(
            topo=TopoParams(
                network_size=a.peers, anchor_stages=3,
                msg_size_bytes=a.msg_size, messages=a.messages,
                delay_seconds=a.delay_s),
            connect_to=a.connect_to,
            gossipsub=gs,
            publisher_id=a.publisher_id,
            warmup_s=a.warmup_s,
            seed=a.seed,
            warm_start=a.warm_start,
        ),
        adversary=AdversaryParams(
            scenario=a.scenario, violation_penalty=a.violation_penalty,
            **adv_kw),
        attack_heartbeats=a.attack_heartbeats,
        vmap_trials=not a.no_vmap,
        checkpoint_dir=a.checkpoint_dir,
        recovery_heartbeats=a.recovery_heartbeats,
        repair=RepairParams(
            evict=a.evict, eviction_threshold=a.eviction_threshold,
            px=a.px, px_count=a.px_count,
            redial=a.redial, redial_patience=a.redial_patience),
        faults=FaultParams(
            crash_frac=a.crash_frac,
            crash_window=_window(a.crash_window, "--crash-window"),
            partition_frac=a.partition_frac,
            partition_window=_window(a.partition_window,
                                     "--partition-window"),
            spike_frac=a.spike_frac,
            spike_window=_window(a.spike_window, "--spike-window"),
            spike_ms=a.spike_ms),
        dht=DhtAdversaryParams(
            lookup_eclipse=a.dht_eclipse,
            rtable_poison=a.dht_poison,
            sybil_cluster=a.dht_cluster,
            heal_hb=a.dht_heal_hb,
            poison_per_peer=a.dht_poison_per_peer,
            cluster_prefix_bits=a.dht_cluster_prefix_bits,
            evict_max_fails=a.dht_evict_max_fails,
            evict_backoff_ms=a.dht_evict_backoff_ms),
        supervisor=SupervisorConfig(
            trial_timeout_s=a.trial_timeout_s,
            max_retries=a.max_retries,
            retry_backoff_s=a.retry_backoff_s,
            inject_failures=a.inject_failures),
    )
    t0 = time.time()
    res = run_campaign(cfg, trial_mesh=trial_mesh, device=device)
    d = res.to_dict()
    print(report_campaign(d), end="")
    if a.json:
        with open(a.json, "w") as f:
            # strict JSON: non-finite metrics are already nulled by to_dict
            json.dump(d, f, indent=2, allow_nan=False)
    if a.metrics_out:
        from .runtime.metrics import CampaignMetrics

        m = CampaignMetrics()
        m.fill_from_campaign(d)
        with open(a.metrics_out, "w") as f:
            f.write(m.render())
    print(_wall_line(device, t0, f" trials={len(res.trials)} "
                     f"trials/s={res.trials_per_s:.3f}"))
    return 0


def cmd_pareto(argv: list[str]) -> int:
    """Defense Pareto sweep: grid the score-defense knobs (the mesh degree
    band, the slow-peer penalty weight) against the adaptive attacker and
    print the coverage / bandwidth / recovery-time front
    (runtime/campaign.run_defense_sweep)."""
    from .ops.adversary import ADAPTIVE_SCENARIOS

    p = argparse.ArgumentParser(prog="pareto")
    p.add_argument("--scenario", choices=ADAPTIVE_SCENARIOS,
                   default="eclipse_publisher",
                   help="adaptive-capable scenario the sweep defends "
                   "against (eclipse_publisher gives the sharpest "
                   "recovery_time_ms separation)")
    p.add_argument("-n", "--peers", type=int, default=64)
    p.add_argument("--fractions", default="0.2",
                   help="comma-separated ATTACKED fractions (> 0); the "
                   "sweep aggregates over all of them")
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--messages", type=int, default=2)
    p.add_argument("--msg-size", type=int, default=2000)
    p.add_argument("--delay-s", type=float, default=0.5)
    p.add_argument("--warmup-s", type=float, default=8.0)
    p.add_argument("--attack-heartbeats", type=int, default=6)
    p.add_argument("--recovery-heartbeats", type=int, default=8)
    p.add_argument("--connect-to", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--publisher-id", type=int, default=4)
    p.add_argument("--throttle-margin", type=float, default=None,
                   help="adaptive duty-cycle setpoint (0 < m < 1)")
    p.add_argument("--degree-grid", default="4:6:8,4:4:6",
                   metavar="DL:D:DH[,...]",
                   help="comma-separated d_low:d:d_high degree bands to "
                   "sweep (the defaults are inserted if absent)")
    p.add_argument("--weight-grid", default="-10", metavar="W[,...]",
                   help="comma-separated slow_peer_penalty_weight values "
                   "(<= 0) to sweep")
    p.add_argument("--json", default=None,
                   help="write the sweep artifact as strict JSON here")
    p.add_argument("--trial-groups", type=int, default=None, metavar="N",
                   help="deal every grid point's seeds over N trial groups "
                   "(parallel/sharding.make_trial_mesh; 0 = one per visible "
                   "device; with --device cpu, N CPU ranks)")
    _device_arg(p)
    a = p.parse_args(argv)

    try:
        degree_grid = tuple(
            tuple(int(x) for x in band.split(":"))
            for band in a.degree_grid.split(",") if band.strip())
        if any(len(b) != 3 for b in degree_grid):
            raise ValueError
    except ValueError:
        p.error(f"--degree-grid must be DL:D:DH[,DL:D:DH...], got "
                f"{a.degree_grid!r}")
    weight_grid = tuple(
        float(s) for s in a.weight_grid.split(",") if s.strip())
    fractions = tuple(float(s) for s in a.fractions.split(",") if s.strip())
    if not fractions or any(f <= 0.0 for f in fractions):
        p.error("--fractions must list attacked fractions > 0 (the sweep "
                "measures the defense against the armed attacker; benign "
                "baselines belong to the attack subcommand)")
    seeds = tuple(int(s) for s in a.seeds.split(",") if s.strip())
    device = _resolve(p, a.device)

    from .ops.adversary import AdaptivePolicy, AdversaryParams
    from .ops.repair import RepairParams
    from .runtime.campaign import (
        CampaignConfig, attack_gossipsub, run_defense_sweep)
    from .runtime.simulator import ExperimentConfig
    from .runtime.summarize import report_defense_sweep

    pol_kw: dict = {"enabled": True}
    if a.throttle_margin is not None:
        pol_kw["throttle_margin"] = a.throttle_margin
    cfg = CampaignConfig(
        scenario=a.scenario,
        fractions=fractions,
        seeds=seeds,
        experiment=ExperimentConfig(
            topo=TopoParams(
                network_size=a.peers, anchor_stages=3,
                msg_size_bytes=a.msg_size, messages=a.messages,
                delay_seconds=a.delay_s),
            connect_to=a.connect_to,
            gossipsub=attack_gossipsub(
                flood_publish=(a.scenario != "eclipse_publisher")),
            publisher_id=a.publisher_id,
            warmup_s=a.warmup_s,
            seed=a.seed,
        ),
        adversary=AdversaryParams(
            scenario=a.scenario, adaptive=AdaptivePolicy(**pol_kw)),
        attack_heartbeats=a.attack_heartbeats,
        recovery_heartbeats=a.recovery_heartbeats,
        repair=RepairParams(evict=True, px=True, redial=True),
    )
    t0 = time.time()
    sweep = run_defense_sweep(cfg, degree_grid=degree_grid,
                              weight_grid=weight_grid,
                              trial_mesh=_trial_grid(p, a.trial_groups,
                                                     device),
                              device=device)
    print(report_defense_sweep(sweep), end="")
    if a.json:
        with open(a.json, "w") as f:
            # strict JSON: run_defense_sweep sanitizes non-finite values
            json.dump(sweep, f, indent=2, allow_nan=False)
    print(_wall_line(device, t0, f" points={len(sweep['configs'])}"))
    return 0


def cmd_arena(argv: list[str]) -> int:
    """Protocol arena: race GossipSub against the episub tree on the same
    graph, traffic, fault cohorts and adaptive attacker
    (runtime/campaign.run_arena_campaign) and print the per-scenario win
    matrix. The benign row rides along by default."""
    from .ops.adversary import ADAPTIVE_SCENARIOS

    p = argparse.ArgumentParser(prog="arena")
    p.add_argument("--scenarios", default="benign,sybil_graft_flood",
                   help="comma-separated scenario list; 'benign' is the "
                   "reserved no-attacker row, the rest must be "
                   f"adaptive-capable ({', '.join(ADAPTIVE_SCENARIOS)})")
    p.add_argument("-n", "--peers", type=int, default=64)
    p.add_argument("--fraction", type=float, default=0.25,
                   help="attacker fraction for every attack scenario")
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--messages", type=int, default=2)
    p.add_argument("--msg-size", type=int, default=2000)
    p.add_argument("--delay-s", type=float, default=0.5)
    p.add_argument("--warmup-s", type=float, default=8.0)
    p.add_argument("--attack-heartbeats", type=int, default=8)
    p.add_argument("--connect-to", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--publisher-id", type=int, default=4)
    p.add_argument("--throttle-margin", type=float, default=None,
                   help="adaptive duty-cycle setpoint (0 < m < 1)")
    p.add_argument("--lazy-degree", type=int, default=None,
                   help="episub lazy-IHAVE budget per round (default: "
                   "the GossipSub d_lazy derivation)")
    p.add_argument("--json", default=None,
                   help="write the arena artifact as strict JSON here")
    p.add_argument("--trial-groups", type=int, default=None, metavar="N",
                   help="deal each attack scenario's seeds over N trial "
                   "groups (parallel/sharding.make_trial_mesh; 0 = one per "
                   "visible device; with --device cpu, N CPU ranks)")
    _device_arg(p)
    a = p.parse_args(argv)

    scenarios = tuple(s.strip() for s in a.scenarios.split(",") if s.strip())
    attack_scs = [s for s in scenarios if s != "benign"]
    bad = [s for s in attack_scs if s not in ADAPTIVE_SCENARIOS]
    if bad:
        p.error(f"scenarios {bad} are not adaptive-capable; choose from "
                f"'benign', {', '.join(ADAPTIVE_SCENARIOS)}")
    if not attack_scs:
        p.error("--scenarios needs at least one attack scenario beside "
                "'benign' (the arena's referee is the adaptive attacker)")
    if not 0.0 < a.fraction < 1.0:
        p.error("--fraction must be in (0, 1)")
    seeds = tuple(int(s) for s in a.seeds.split(",") if s.strip())
    device = _resolve(p, a.device)

    from .ops.adversary import AdaptivePolicy, AdversaryParams
    from .ops.episub import EpisubParams
    from .runtime.campaign import (
        CampaignConfig, attack_gossipsub, run_arena_campaign)
    from .runtime.simulator import ExperimentConfig
    from .runtime.summarize import report_arena

    pol_kw: dict = {"enabled": True}
    if a.throttle_margin is not None:
        pol_kw["throttle_margin"] = a.throttle_margin
    cfg = CampaignConfig(
        scenario=attack_scs[0],
        fractions=(a.fraction,),
        seeds=seeds,
        experiment=ExperimentConfig(
            topo=TopoParams(
                network_size=a.peers, anchor_stages=3,
                msg_size_bytes=a.msg_size, messages=a.messages,
                delay_seconds=a.delay_s),
            connect_to=a.connect_to,
            # flood publish off: arena traffic rides mesh_mask, the
            # surface the two protocols differ on
            gossipsub=attack_gossipsub(flood_publish=False),
            publisher_id=a.publisher_id,
            warmup_s=a.warmup_s,
            seed=a.seed,
        ),
        adversary=AdversaryParams(
            scenario=attack_scs[0], adaptive=AdaptivePolicy(**pol_kw)),
        attack_heartbeats=a.attack_heartbeats,
    )
    ep = None
    if a.lazy_degree is not None:
        ep = EpisubParams(root=a.publisher_id % a.peers,
                          lazy_degree=a.lazy_degree)
    t0 = time.time()
    arena = run_arena_campaign(cfg, scenarios=scenarios, ep=ep,
                               trial_mesh=_trial_grid(p, a.trial_groups,
                                                      device),
                               device=device)
    print(report_arena(arena), end="")
    if a.json:
        with open(a.json, "w") as f:
            # strict JSON: run_arena_campaign sanitizes non-finite values
            json.dump(arena, f, indent=2, allow_nan=False)
    print(_wall_line(device, t0, f" trials={len(arena['trials'])}"))
    return 0


def cmd_conform(argv: list[str]) -> int:
    """Conformance oracle: spec-differential certification of the engine's
    step against the pure-numpy GossipSub v1.1 reference model
    (analysis/conformance.py), its sim side on --device.

    Emits the strict-JSON certificate (stdout or --out). Exit 0 iff every
    divergence is absent or carries a documented_choice waiver
    (docs/CONFORMANCE.md); any sim_bug is a hard failure.
    """
    p = argparse.ArgumentParser(prog="conform")
    p.add_argument("--all-scenarios", action="store_true",
                   help="run the full canon: all 8 attack scenarios plus "
                        "the adaptive, faults, churn and cross-fragment "
                        "entries (default when no --scenario is given)")
    p.add_argument("--scenario", action="append", default=None,
                   help="restrict to specific attack scenario(s); "
                        "repeatable. Skips the adaptive/faults/churn/"
                        "gossip entries unless --all-scenarios is also set")
    p.add_argument("--n", type=int, default=48,
                   help="peers per differential instance (default 48)")
    p.add_argument("--connect-to", type=int, default=8)
    p.add_argument("--steps", type=int, default=8,
                   help="attack heartbeats walked per instance")
    p.add_argument("--warm-steps", type=int, default=4)
    p.add_argument("--seeds", type=int, nargs="+", default=[0],
                   help="fuzz seeds; each reseeds graph, state and cohort")
    p.add_argument("--fuzz", type=int, default=0, metavar="N",
                   help="append N random-parameter-grid entries: each "
                        "samples degree bounds (0 < d_low <= d <= d_high "
                        "<= capacity), gossip factor and score weights, "
                        "then runs the differential under that grid, "
                        "cycling through the attack canon")
    p.add_argument("--fuzz-seed", type=int, default=0,
                   help="PRNG stream for --fuzz grid sampling (default 0)")
    p.add_argument("--out", default=None,
                   help="certificate path (default: stdout)")
    _device_arg(p)
    a = p.parse_args(argv)
    device = _resolve(p, a.device)

    from .analysis.conformance import (conformance_certificate,
                                       write_certificate)
    from .runtime.summarize import sanitize_nonfinite

    full = a.all_scenarios or a.scenario is None
    cert = conformance_certificate(
        scenarios=a.scenario, n=a.n, connect_to=a.connect_to,
        seeds=tuple(a.seeds), steps=a.steps, warm_steps=a.warm_steps,
        include_adaptive=full, include_faults=full, include_churn=full,
        include_gossip=full, fuzz=a.fuzz, fuzz_seed=a.fuzz_seed,
        device=device)
    if a.out:
        write_certificate(cert, a.out)
    else:
        print(json.dumps(sanitize_nonfinite(cert), indent=2,
                         allow_nan=False))
    for e in cert["entries"]:
        line = f"conform: {e['scenario']:<22} {e['status']}"
        if e["divergences"]:
            line += f" ({len(e['divergences'])} divergence(s), " \
                    f"{e['sim_bugs']} sim_bug(s))"
        print(line, file=sys.stderr)
    return 0 if cert["clean"] else 1


def cmd_trace(argv: list[str]) -> int:
    """Flight-recorder trace export: a self-contained mini-run (warmup
    untraced, then a recorded window) whose per-heartbeat tel_* curves are
    written as a perfetto-loadable Chrome-trace JSON plus .npz/CSV sidecars.
    Strict-JSON summary on stdout, exit 0 on success."""
    p = argparse.ArgumentParser(prog="trace")
    p.add_argument("-n", "--network-size", type=int, default=64)
    p.add_argument("--connect-to", type=int, default=6)
    p.add_argument("--heartbeats", type=int, default=20,
                   help="recorded window length in heartbeats")
    p.add_argument("--warmup-hb", type=int, default=10,
                   help="untraced mesh-stabilization rounds before recording")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--degree-bins", type=int, default=12)
    p.add_argument("--out", default="trace_out",
                   help="output directory for the trace artifacts")
    p.add_argument("--profile-dir", default=None,
                   help="also capture a torch.profiler trace into this dir")
    _device_arg(p)
    a = p.parse_args(argv)
    device = _resolve(p, a.device)

    from .ops.telemetry import TelemetryParams
    from .runtime.campaign import attack_gossipsub
    from .runtime.profiling import chrome_trace, profiler_trace
    from .runtime.simulator import ExperimentConfig, Simulator
    from .runtime.summarize import sanitize_nonfinite

    cfg = ExperimentConfig(
        topo=TopoParams(network_size=a.network_size, anchor_stages=5,
                        min_bandwidth=50, max_bandwidth=150,
                        min_latency=40, max_latency=130),
        connect_to=a.connect_to,
        # armed score params: the recorder's score quantiles / graylist
        # fraction measure nothing against the default weights
        gossipsub=attack_gossipsub(),
        warmup_s=0.0,
        seed=a.seed,
    )
    sim = Simulator(cfg, device=device)
    hb_ms = float(sim.params.heartbeat_ms)
    tp = TelemetryParams(record=True, degree_bins=a.degree_bins)
    tp.validate()
    with profiler_trace(a.profile_dir, device=device):
        sim.advance(a.warmup_hb * hb_ms)      # untraced warmup
        sim.record_telemetry(tp)
        t0_ms = float(sim.state.t_ms)
        sim.advance(a.heartbeats * hb_ms)     # the recorded window
    tel = sim.last_telemetry
    if not tel:
        print("flight recorder produced no rounds "
              "(heartbeats too small for the heartbeat interval?)",
              file=sys.stderr)
        return 1

    os.makedirs(a.out, exist_ok=True)
    ct = chrome_trace(tel, hb_ms, t0_ms=t0_ms,
                      name=f"gossipsub n={a.network_size} seed={a.seed}")
    trace_path = os.path.join(a.out, "trace.perfetto.json")
    with open(trace_path, "w") as fh:
        json.dump(sanitize_nonfinite(ct), fh, allow_nan=False)
    npz_path = os.path.join(a.out, "rounds.npz")
    with open(npz_path, "wb") as fh:
        np.savez_compressed(fh, **{k: np.asarray(v) for k, v in tel.items()})
    # CSV: one row per heartbeat, vector channels expanded per index
    cols = []
    for k in sorted(tel):
        arr = np.asarray(tel[k])
        if arr.ndim == 1:
            cols.append((k, arr))
        else:
            cols.extend((f"{k}_{j}", arr[:, j]) for j in range(arr.shape[1]))
    steps = int(cols[0][1].shape[0])
    csv_path = os.path.join(a.out, "rounds.csv")
    with open(csv_path, "w") as fh:
        fh.write("hb," + ",".join(k for k, _ in cols) + "\n")
        for i in range(steps):
            fh.write(f"{i}," + ",".join(
                format(float(v[i]), "g") for _, v in cols) + "\n")

    cov = np.asarray(tel["tel_mesh_coverage"])
    hits = np.nonzero(cov >= 0.9)[0]
    summary = {
        "network_size": a.network_size,
        "heartbeats": steps,
        "heartbeat_ms": hb_ms,
        "channels": sorted(tel),
        "coverage90_hb": int(hits[0]) + 1 if hits.size else -1,
        "final_mean_degree": float(np.asarray(tel["tel_mean_degree"])[-1]),
        "trace_json": trace_path,
        "rounds_npz": npz_path,
        "rounds_csv": csv_path,
        "profile_dir": a.profile_dir,
    }
    print(json.dumps(sanitize_nonfinite(summary), indent=2, allow_nan=False))
    return 0


# the lint flags of the peer mesh: set, each exits with an error naming
# its slice (never silently ignored)
_LATER_LINT_FLAGS = (
    ("sharding", "--sharding"), ("predict_rung", "--predict-rung"),
    ("rung_dcn", "--rung-dcn"), ("rung_scenario", "--rung-scenario"),
    ("rung_out", "--rung-out"),
)


def cmd_lint(argv: list[str]) -> int:
    """graft-audit on the port: the AST lint (GA-A005) over the port's
    sources and the contract engine over every registered entry point
    (analysis/registry.py), run on --device. Emits the strict-JSON
    violation report (the reference's shape) on stdout or --out. Exit 0
    iff clean."""
    p = argparse.ArgumentParser(prog="lint")
    p.add_argument("paths", nargs="*",
                   help="files/dirs for the AST engine (default: the port "
                        "package and chip_smoke.py)")
    p.add_argument("--no-ast", action="store_true",
                   help="skip the AST lint engine")
    p.add_argument("--no-jaxpr", action="store_true",
                   help="skip the contract engine (runs no entry point)")
    p.add_argument("--checkify", action="store_true",
                   help="also run the contracts' runtime checks (value "
                        "invariants asserted in plain torch)")
    p.add_argument("--only", default=None, metavar="PREFIX",
                   help="restrict the contract engine to contracts whose "
                        "name starts with PREFIX (e.g. disseminate/)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the strict-JSON report to PATH instead of "
                        "stdout (github annotations still print to stdout)")
    p.add_argument("--format", choices=("json", "github"), default="json",
                   help="'github' additionally emits ::error/::notice "
                        "workflow-command lines")
    later = p.add_argument_group("later slices")
    later.add_argument("--sharding", action="store_true")
    later.add_argument("--predict-rung", nargs="?", const=1048576, type=int,
                       default=None, metavar="PEERS")
    later.add_argument("--rung-dcn", type=int, default=None)
    later.add_argument("--rung-scenario", choices=("attack", "arena"),
                       default=None)
    later.add_argument("--rung-out", default=None)
    _device_arg(p)
    a = p.parse_args(argv)
    for attr, flag in _LATER_LINT_FLAGS:
        if getattr(a, attr) not in (None, False):
            from .parallel.sharding import PEER_MESH_SLICE

            p.error(f"{flag} is not ported yet: it comes with "
                    f"{PEER_MESH_SLICE} (ROADMAP A)")
    device = _resolve(p, a.device)

    from .analysis.ast_lint import lint_paths
    from .analysis.jaxpr_audit import audit_contracts, run_checkify
    from .analysis.registry import default_contracts
    from .analysis.report import github_annotations, render_report

    pkg = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(pkg)
    violations = []
    checked_files = 0
    checked_entrypoints = 0
    if not a.no_ast:
        smoke = os.path.join(repo_root, "chip_smoke.py")
        targets = a.paths or [pkg] + ([smoke] if os.path.exists(smoke)
                                      else [])
        ast_violations, checked_files = lint_paths(targets, repo_root)
        violations.extend(ast_violations)
    if not a.no_jaxpr:
        contracts = default_contracts(device)
        if a.only:
            contracts = [c for c in contracts if c.name.startswith(a.only)]
        checked_entrypoints = len(contracts)
        violations.extend(audit_contracts(contracts))
        if a.checkify:
            violations.extend(run_checkify(contracts))

    if a.format == "github":
        for line in github_annotations(violations):
            print(line)
    report = render_report(violations, checked_files=checked_files,
                           checked_entrypoints=checked_entrypoints)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(report + "\n")
    else:
        print(report)
    return 1 if violations else 0


def cmd_microbench(argv: list[str]) -> int:
    """Microbenchmark + launch tuning harness (runtime/microbench.py):
    rooflines per registered entry point, the kernels' launch-parameter
    sweep and the packed_state A/B, on --device. Strict-JSON artifact,
    exit 0 on success."""
    from .runtime.microbench import run

    run(argv)
    return 0


COMMANDS = {
    "run": cmd_run,
    "kad": cmd_kad,
    "connmanager": cmd_connmanager,
    "regression": cmd_regression,
    "servicedisco": cmd_servicedisco,
    "serve": cmd_serve,
    "inject": cmd_inject,
    "attack": cmd_attack,
    "pareto": cmd_pareto,
    "arena": cmd_arena,
    "conform": cmd_conform,
    "trace": cmd_trace,
    "lint": cmd_lint,
    "microbench": cmd_microbench,
    "topogen": cmd_topogen,
    "summarize": cmd_summarize,
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m dst_libp2p_test_node_tpu_torch "
              "{" + ",".join(COMMANDS) + "} ... [--device cpu]\n"
              "  run <14 positionals> [--delivery-mode exact|bounded] ...\n"
              "  conform [--scenario S ...] [--seeds 0 1] [--out F]\n"
              "  trace [-n PEERS] [--heartbeats H] [--out DIR] "
              "[--profile-dir DIR]\n"
              "  lint [paths] [--no-ast] [--no-jaxpr] [--checkify] "
              "[--only P] [--out F]\n"
              "  microbench [--only P] [--no-sweep] [--no-packed] "
              "[--install] [--out F]",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])
