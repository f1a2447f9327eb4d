#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure (exit code 1, and the final `ok` line is
not printed):

  1. build   - nvcc builds every kernel of the port from native/csrc/ (one
               process per source, all at once); prints the card's name
               and power limit as nvidia-smi reports them.
  2. kernels - each kernel against its plain-torch version on the card, at
               the main path's shape (1M peers x 40 slots) and at a ragged
               small shape with -1 pads: vmem_gather bitwise (also
               batched), score_update's decayed counters bitwise and its
               score within rtol 1e-5 / atol 1e-6. Times each (CUDA events)
               beside its plain version, a library yardstick and its bound.
  3. parity  - the Simulator at 2048 peers on CUDA and on the CPU, with the
               pull budget lowered so the receiver-side path (and so the
               gather kernel) runs: latencies, shadowlog and summaries must
               be byte-identical.
  4. main    - the port's `run` entry at full width: 1,000,000 peers,
               CONNECTTO=10, 15 KB, 1 fragment, 3 messages, bounded
               delivery mode, a 30 s warm-up. Kernel launch counts are
               zeroed just before and read just after; fails on coverage
               < 1, an unconverged fixpoint or a kernel of the path that
               never launched.
  5. idle    - a second 1M-peer Simulator: set-up, warm-up and one publish
               timed apart, then one more publish under torch.profiler:
               device busy time over wall time.

Then one JSON line with every kernel's numbers, and last the line
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no
result; run alone, without the package beside it, it exits 2.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, ".smoke_tmp")     # big outputs, removed at end

# H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA's H100 data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FULL_N = 1_000_000
FULL_WARMUP_S = 30.0
PARITY_N = 2048
# run.sh positionals of the full-size run: config 5's topology
# (anchor_stages 5, 50-150 Mbit, 40-130 ms, 15 KB, 2 s spacing)
FULL_ARGS = ["1", str(FULL_N), "15000", "1", "3", "50", "150", "40", "130",
             "5", "0.0", "4", "0", "2000"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20):
    """Mean ms per call over `iters` calls, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(plain, kernel):
    """Time in turns (plain, kernel, kernel, plain); min of each pair."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), \
        cuda_ms(plain)
    return min(k1, k2), min(p1, p2)


def bound_ms(nbytes, flops=0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1

def phase_build():
    from dst_libp2p_test_node_tpu_torch.native import build

    t0 = time.time()
    paths = build.build()
    print(f"[build] {len(paths)} kernels built in {time.time() - t0:.1f} s: "
          + ", ".join(os.path.relpath(p, ROOT) for p in paths.values()))
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


# ---------------------------------------------------------------- phase 2

def _gather_inputs(n, c, gen, dev, batch=None):
    shape = (n, c) if batch is None else (batch, n, c)
    t_shape = (n,) if batch is None else (batch, n)
    t = torch.rand(t_shape, generator=gen, device=dev) * 4000.0
    t[..., ::7] = 3.4e38                         # unreached senders
    src = torch.randint(0, n, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    pad = torch.rand(shape, generator=gen, device=dev) < 0.1
    src = torch.where(pad, -1, src).to(torch.int32)
    return t, src


def phase_kernels(dev):
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops.state import SimParams

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # -- vmem_gather: bitwise, plain / batched / shared-t batched -------------
    for n, c in ((1000, 37), (FULL_N, 40)):
        t, src = _gather_inputs(n, c, gen, dev)
        check(torch.equal(vg.vmem_gather(t, src), vg.vmem_gather_ref(t, src)),
              f"vmem_gather != plain at {n}x{c}")
        tb, srcb = _gather_inputs(n, c, gen, dev, batch=3)
        check(torch.equal(vg.vmem_gather(tb, srcb),
                          vg.vmem_gather_ref(tb, srcb)),
              f"batched vmem_gather != plain at 3x{n}x{c}")
        check(torch.equal(vg.vmem_gather(t, srcb),
                          vg.vmem_gather_ref(t, srcb)),
              f"shared-t vmem_gather != plain at 3x{n}x{c}")
    torch.cuda.synchronize()
    ms, plain = paired_ms(lambda: vg.vmem_gather_ref(t, src),
                          lambda: vg.vmem_gather(t, src))
    lib = cuda_ms(lambda: t[src.clamp_min(0)])
    b, by = bound_ms(src.numel() * 4 + t.numel() * 4 + src.numel() * 4)
    out["vmem_gather"] = dict(
        name="vmem_gather", route="cuda",
        source="dst_libp2p_test_node_tpu_torch/native/csrc/vmem_gather.cu",
        replaces="dst_libp2p_test_node_tpu/native/vmem_gather.py:87",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=lib, shape=[FULL_N, 40])
    print(f"[kernels] vmem_gather bitwise at 1000x37 and {FULL_N}x40 "
          f"(plain, batched, shared t); {ms:.4f} ms vs plain {plain:.4f} ms, "
          f"t[src.clamp_min(0)] {lib:.4f} ms, bound {b:.4f} ms ({by})")

    # -- score_update: counters bitwise, score rtol 1e-5 / atol 1e-6 --------
    err = 0.0
    for n, c in ((1000, 37), (FULL_N, 40)):
        params = SimParams(n=n, capacity=c, slow_weight=-10.0)
        fmd = torch.rand((n, c), generator=gen, device=dev) * 3.0
        slow = torch.rand((n, c), generator=gen, device=dev) * 0.5
        scales = torch.tensor([0.9 ** 7, 0.2 ** 3], dtype=torch.float32,
                              device=dev)
        got = su.score_update(fmd, slow, scales, params)
        want = su.score_update_ref(fmd, slow, scales, params)
        check(torch.equal(got[0], want[0]), f"score_update fmd at {n}x{c}")
        check(torch.equal(got[1], want[1]), f"score_update slow at {n}x{c}")
        check(torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-6),
              f"score_update score at {n}x{c}")
        err = max(err, float((got[2] - want[2]).abs().max()))
    torch.cuda.synchronize()
    ms, plain = paired_ms(lambda: su.score_update_ref(fmd, slow, scales,
                                                      params),
                          lambda: su.score_update(fmd, slow, scales, params))
    b, by = bound_ms(fmd.numel() * 4 * 5 + 8, flops=fmd.numel() * 7.0)
    out["score_update"] = dict(
        name="score_update", route="cuda",
        source="dst_libp2p_test_node_tpu_torch/native/csrc/score_update.cu",
        replaces="dst_libp2p_test_node_tpu/native/score_update.py:90",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None, shape=[FULL_N, 40])
    print(f"[kernels] score_update counters bitwise, score max |err| {err:g} "
          f"at 1000x37 and {FULL_N}x40; {ms:.4f} ms vs plain {plain:.4f} ms, "
          f"bound {b:.4f} ms ({by})")
    return out


# ---------------------------------------------------------------- phase 3

def _outputs(sim):
    from dst_libp2p_test_node_tpu_torch.runtime.bandwidth import (
        shadowlog_lines)

    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return (buf.getvalue(), "\n".join(shadowlog_lines(sim.traffic())),
            sim.summary_report() + sim.bandwidth_report())


def phase_parity(dev):
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
    from dst_libp2p_test_node_tpu_torch.ops import pull
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = TopoParams(network_size=PARITY_N, anchor_stages=5,
                      min_bandwidth=50, max_bandwidth=150, min_latency=40,
                      max_latency=130, msg_size_bytes=15000, num_frags=1,
                      messages=3, delay_seconds=2.0)
    cfg = ExperimentConfig(topo=topo, seed=3, warmup_s=30.0,
                           serialize_answers=False)
    saved = pull._MAX_INTERMEDIATE_BYTES
    pull._MAX_INTERMEDIATE_BYTES = 1     # force the receiver-side path
    try:
        before = vg.launches
        t0 = time.time()
        sim_gpu = Simulator(cfg, device=dev)
        sim_gpu.run()
        gpu_out = _outputs(sim_gpu)
        t1 = time.time()
        check(vg.launches > before, "parity run never launched vmem_gather")
        sim_cpu = Simulator(cfg, device="cpu")
        sim_cpu.run()
        cpu_out = _outputs(sim_cpu)
        t2 = time.time()
    finally:
        pull._MAX_INTERMEDIATE_BYTES = saved
    for what, a, b in zip(("latencies", "shadowlog", "summaries"),
                          gpu_out, cpu_out):
        check(a == b, f"CUDA and CPU {what} differ at {PARITY_N} peers")
    lines = gpu_out[0].count("\n")
    check(lines == 3 * PARITY_N, f"parity run wrote {lines} latency lines")
    print(f"[parity] {PARITY_N} peers, receiver-side path: latencies "
          f"({lines} lines), shadowlog and summaries byte-identical on CUDA "
          f"({t1 - t0:.1f} s) and CPU ({t2 - t1:.1f} s)")


# ---------------------------------------------------------------- phase 4

def phase_main(dev):
    from dst_libp2p_test_node_tpu_torch import cli
    from dst_libp2p_test_node_tpu_torch.native import score_update as su
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg

    os.makedirs(SCRATCH, exist_ok=True)
    prefix = os.path.join(SCRATCH, "full_")
    argv = ["run", *FULL_ARGS, "--delivery-mode", "bounded",
            "--warmup-s", str(FULL_WARMUP_S), "--out-prefix", prefix,
            "--stats-json"]
    print(f"[main] python -m dst_libp2p_test_node_tpu_torch "
          f"{' '.join(argv)}  (warm-up {FULL_WARMUP_S:g} s = "
          f"{FULL_WARMUP_S:g} heartbeats, cut from the default 500 s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    vg.launches = 0
    su.launches = 0
    t0 = time.time()
    rc = cli.main(argv)
    wall_total = time.time() - t0
    launches = {"vmem_gather": vg.launches, "score_update": su.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"run exited {rc}")
    with open(prefix + "stats1.json") as f:
        stats = json.load(f)
    with open(prefix + "latencies1") as f:
        lines = sum(1 for _ in f)
    coverage = stats["coverage"] / FULL_N
    print(f"[main] wall {stats['wall_s']:.3f} s (simulation), "
          f"{wall_total:.3f} s with outputs; peer-rounds/s "
          f"{stats['peer_rounds_per_sec']:.1f}; coverage {coverage}; "
          f"p50 {stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms; "
          f"converged {stats['converged']}; answer_wait_max "
          f"{stats['answer_wait_max_ms']:.3f} ms; launches {launches}; "
          f"peak memory {peak / 2**30:.2f} GiB; {lines} latency lines")
    check(coverage >= 1.0, f"coverage {coverage} < 1")
    check(stats["converged"], "a fixpoint hit its iteration cap")
    check(lines == 3 * FULL_N, f"{lines} latency lines, want {3 * FULL_N}")
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")
    return launches, stats, peak


# ---------------------------------------------------------------- phase 5

def phase_idle(dev):
    """Device busy share of one 1M-peer publish (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dst_libp2p_test_node_tpu_torch.cli import (RUN_SH_PARAMS,
                                                    _topo_from_fields)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    topo = _topo_from_fields(dict(zip(RUN_SH_PARAMS, FULL_ARGS)))
    cfg = ExperimentConfig(topo=topo, warmup_s=5.0, serialize_answers=False)
    t0 = time.time()
    sim = Simulator(cfg, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    sim.warmup()
    torch.cuda.synchronize()
    t2 = time.time()
    sim.publish(cfg.publisher_id)
    torch.cuda.synchronize()
    t3 = time.time()
    print(f"[idle] at {FULL_N} peers: Simulator set-up (graph build, state, "
          f"edge tables) {t1 - t0:.3f} s; warm-up of 5 heartbeats "
          f"{t2 - t1:.3f} s; one publish {t3 - t2:.3f} s (unprofiled)")
    sim.advance(2000.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        sim.publish(cfg.publisher_id)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = prof.key_averages()
    # kernel rows only: CPU-op rows repeat the time of the kernels they
    # launched
    events = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        print("[idle] profiler recorded no device time: idle share not "
              "measured")
        return None
    idle = 1.0 - busy_us / 1e6 / wall
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    ops = sorted((e for e in rows if e.device_type != DeviceType.CUDA
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:12]
    print("[idle] device time by aten op: " + "; ".join(
        f"{e.key} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
        for e in ops))
    print(f"[idle] one publish at {FULL_N} peers under the profiler: wall "
          f"{wall:.3f} s, device busy {busy_us / 1e6:.3f} s, idle share "
          f"{idle:.4f}; top device time: "
          + "; ".join(f"{e.key} {e.self_device_time_total / 1e3:.1f} ms"
                      for e in top[:6]))
    return idle


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    try:
        phase_build()
        kernels = phase_kernels(dev)
        phase_parity(dev)
        launches, _, _ = phase_main(dev)
        phase_idle(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    line = [dict(v, launches=launches[k]) for k, v in kernels.items()]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        import dst_libp2p_test_node_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run it from "
              "the root of a checkout", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
