"""Two-process DCN smoke of the PyTorch port's multi-process path
(dst_libp2p_test_node_tpu_torch/parallel/sharding.py).

Two local processes join one gloo torch.distributed group over
localhost, the way hosts of a multi-host campaign would, and each:

  1. joins the group through initialize_multihost (the wrapper under
     test), at a bind-probed localhost port;
  2. checks that the global device view spans both processes: every
     process's devices gathered over the group;
  3. builds the 3-level dcn x trials x peers grid (make_dcn_mesh): one
     dcn block per process, its own trial groups as the local submesh;
  4. runs real cross-process collectives and checks them: an all_reduce
     of each process's slice of arange(64) (every process must see the
     global sum) and dcn_allreduce's sum and max, the channel the DCN
     campaign's merge rides on;
  5. runs one simulation step with the fixpoint sharded across the
     process boundary: a 64-peer Simulator built on each process's rows
     of a peer mesh over the two processes (parallel/peer.PeerGroup over
     the world group, runtime/sharded.rank_simulator), one heartbeat and
     one exact disseminate, whose fixpoints run through converge_sharded;
     each process checks its rows of every result and state leaf against
     the single-process run of the same seed (answer_queue_mode "serial",
     the refinement engine a mesh takes), bitwise.

Run:  python scripts/dcn_smoke_torch.py [--device cpu]
      python scripts/dcn_smoke_torch.py --worker I (internal: one member)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

NUM_PROCS = 2
# stderr fragments that mean the first process lost the bind race: the
# one failure worth a relaunch on a fresh port
_BIND_RACE = ("EADDRINUSE", "Address already in use",
              "address already in use")


def free_port() -> int:
    """A localhost port the kernel just assigned, released again (main
    retries the launch if another process takes it first)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(process_id: int, device: str | None) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from dst_libp2p_test_node_tpu_torch.device import resolve_device
    from dst_libp2p_test_node_tpu_torch.parallel.sharding import (
        DCN_AXIS, dcn_allreduce, initialize_multihost, local_trial_submesh,
        make_dcn_mesh)

    dev = resolve_device(device)
    port = int(os.environ["DCN_SMOKE_PORT"])
    pid = initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=NUM_PROCS,
                               process_id=process_id, timeout_s=300.0)
    assert pid == process_id, (pid, process_id)

    local = ([str(dev)] if dev.type == "cpu" else
             [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    views = [None] * NUM_PROCS
    dist.all_gather_object(views, (process_id, local))
    n_global = sum(len(v[1]) for v in views)
    assert [v[0] for v in views] == list(range(NUM_PROCS)), views
    assert n_global == NUM_PROCS * len(local), views

    mesh = make_dcn_mesh(devices=local)
    assert mesh.shape[DCN_AXIS] == NUM_PROCS, mesh.shape
    sub = local_trial_submesh(mesh)
    assert DCN_AXIS not in sub.shape and sub.groups == mesh.groups

    n = 64
    rows = n // NUM_PROCS
    part = torch.arange(n, dtype=torch.float32)[
        process_id * rows:(process_id + 1) * rows]
    total = part.sum().reshape(1)
    dist.all_reduce(total)
    expect = float(np.arange(n).sum())
    assert float(total[0]) == expect, (float(total[0]), expect)
    got_sum = dcn_allreduce([float(part.sum()), 1.0], op="sum")
    got_max = dcn_allreduce([float(process_id)], op="max")
    assert got_sum.tolist() == [expect, float(NUM_PROCS)], got_sum
    assert got_max.tolist() == [float(NUM_PROCS - 1)], got_max

    rows = step5(process_id, dev)

    print(f"worker {process_id}: global_devices={n_global} "
          f"grid={mesh.shape} all_reduce={float(total[0])} "
          f"dcn_allreduce sum={got_sum.tolist()} max={got_max.tolist()} "
          f"fixpoint rows={rows} sharded==single-process OK", flush=True)
    dist.destroy_process_group()


def step5(process_id: int, dev) -> str:
    """One heartbeat and one disseminate on this process's rows of a
    64-peer peer mesh over the world, against the single-process run:
    every result and state leaf's rows bitwise. Returns the rows."""
    import dataclasses

    import numpy as np
    import torch

    from dst_libp2p_test_node_tpu_torch import interop
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.parallel import peer
    from dst_libp2p_test_node_tpu_torch.runtime.sharded import (
        rank_simulator)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    cfg = ExperimentConfig(
        topo=TopoParams(network_size=64, anchor_stages=2, min_bandwidth=50,
                        max_bandwidth=100, min_latency=40, max_latency=80,
                        msg_size_bytes=15000, num_frags=2),
        connect_to=6, warmup_s=1.0, seed=5,
        # the engine a mesh takes for exact refinement
        answer_queue_mode="serial")
    ref = Simulator(cfg, device=dev)
    ref.warmup()
    want = ref._disseminate(4, ref._t_now(), 15000, False)
    grp = peer.PeerGroup(process_id, NUM_PROCS, 64, dev)
    sim = rank_simulator("single", cfg, ref.topology, dev, grp)
    with peer.using(grp):
        sim.warmup()
        got = sim._disseminate(4, sim._t_now(), 15000, False)
    assert grp.stats["all_gather"] > 0 and grp.stats["all_reduce"] > 0
    rows = slice(grp.r0, grp.r1)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        w = w[rows] if w.dim() >= 1 else w
        assert torch.equal(w.cpu(), g.cpu()), f"result {f.name} differs"
    mine = interop.state_to_numpy(sim.state)
    for k, w in interop.state_to_numpy(ref.state).items():
        w = w if k in ("t_ms", "key") else w[rows]
        assert np.array_equal(w, mine[k]), f"state {k} differs"
    return f"[{grp.r0}, {grp.r1})"


def _launch(port: int, device: str | None) -> tuple[bool, str]:
    """One two-worker launch on `port`: (ok, combined transcript)."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["DCN_SMOKE_PORT"] = str(port)
    extra = ["--device", device] if device else []
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i)]
        + extra, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(NUM_PROCS)]
    ok, transcript = True, ""
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            transcript += out
            if p.returncode != 0 or "OK" not in out:
                ok = False
    except subprocess.TimeoutExpired:
        ok = False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return ok, transcript


def main(device: str | None) -> int:
    attempts = int(os.environ.get("DCN_SMOKE_BIND_RETRIES", "3"))
    ok = False
    for attempt in range(attempts):
        port = free_port()
        ok, transcript = _launch(port, device)
        sys.stdout.write(transcript)
        if ok or not any(tok in transcript for tok in _BIND_RACE):
            break
        print(f"dcn_smoke_torch: port {port} raced, re-probing "
              f"[{attempt + 1}/{attempts}]", flush=True)
    print("dcn_smoke_torch:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the CPU)")
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.device)
    else:
        sys.exit(main(args.device))
