"""Two-process DCN campaign of the PyTorch port: the DCN engine end to end.

Drives runtime/campaign.run_campaign(dcn=...) the way a multi-host run
would: two torch.distributed processes in one gloo group (a FileStore in
the work directory, no TCP port), each on its own trial grid of G groups
(a 2 x G x 1 dcn x trials x peers grid), and holds the merged result
against the single-process campaign over the same seeds, on one
process's grid (G groups; with G = 1 the process runs every trial):

  - the merged trials must be identical field for field outside the
    walls: the process split moves placement, never numerics;
  - scaling_efficiency = dcn_trials_per_s / single_trials_per_s is
    reported beside it (the DCN run has twice the single run's groups).

Writes one strict-JSON result file (--out): the reference launcher's keys
(scripts/dcn_campaign.py), `devs_per_proc` the trial groups per process,
plus the device.

Run:  python scripts/dcn_campaign_torch.py --out dcn.json [--device cpu]
      python scripts/dcn_campaign_torch.py --worker I ... (internal: a rank)
      python scripts/dcn_campaign_torch.py --single ...   (internal: the
                                                           reference run)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

NUM_PROCS = 2

# the merged artifact and the single-process run agree on every field
# but these
_TIMING_KEYS = ("wall_s", "trials_per_s")


def _campaign_cfg(args, checkpoint_dir: str | None):
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import (
        CampaignConfig, attack_gossipsub)
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    exp = ExperimentConfig(
        topo=TopoParams(network_size=args.n, anchor_stages=2,
                        min_bandwidth=50, max_bandwidth=150, min_latency=40,
                        max_latency=130, msg_size_bytes=2000, messages=2,
                        delay_seconds=1.0),
        connect_to=8, gossipsub=attack_gossipsub(), warmup_s=8.0, seed=0)
    return CampaignConfig(
        fractions=tuple(float(f) for f in args.fractions.split(",")),
        seeds=tuple(range(args.seeds)),
        experiment=exp,
        attack_heartbeats=args.heartbeats,
        checkpoint_dir=checkpoint_dir,
        conformance=args.conformance,
    )


def _devices(args, count: int) -> list[str]:
    """`count` trial-group devices: the CPU, or the visible CUDA devices
    dealt round-robin (ranks share a card when there are fewer)."""
    if args.device == "cpu":
        return ["cpu"] * count
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise SystemExit("no CUDA device is available; pass --device cpu")
    return [f"cuda:{i % n}" for i in range(count)]


def worker(args) -> None:
    import torch.distributed as dist

    from dst_libp2p_test_node_tpu_torch.parallel.sharding import (
        initialize_multihost, make_dcn_mesh)
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    store = os.path.join(args.workdir, "dcn_store")
    pid = initialize_multihost(coordinator_address=f"file://{store}",
                               num_processes=NUM_PROCS,
                               process_id=args.worker,
                               timeout_s=args.timeout)
    assert pid == args.worker, (pid, args.worker)
    devs = _devices(args, args.groups)
    mesh = make_dcn_mesh(trial_groups=args.groups, devices=devs)
    cfg = _campaign_cfg(args, os.path.join(args.workdir, "dcn"))
    res = run_campaign(cfg, dcn=mesh, device=devs[0])
    # both workers leave the group together: a gloo group torn down at
    # interpreter exit while the other worker still runs can abort it
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {args.worker}: trials={len(res.trials)} "
          f"wall={res.wall_s:.2f}s merged OK", flush=True)


def single(args) -> None:
    from dst_libp2p_test_node_tpu_torch.parallel.sharding import (
        make_trial_mesh)
    from dst_libp2p_test_node_tpu_torch.runtime.campaign import run_campaign

    devs = _devices(args, args.groups)
    ckpt = os.path.join(args.workdir, "single_ckpt")
    os.makedirs(ckpt, exist_ok=True)
    res = run_campaign(_campaign_cfg(args, ckpt),
                       trial_mesh=make_trial_mesh(devices=devs),
                       device=devs[0])
    out = os.path.join(args.workdir, "single.json")
    with open(f"{out}.tmp", "w") as f:
        json.dump(res.to_dict(), f, allow_nan=False, sort_keys=True,
                  indent=2)
    os.replace(f"{out}.tmp", out)
    print(f"single: trials={len(res.trials)} wall={res.wall_s:.2f}s OK",
          flush=True)


def _spawn(cmd_args: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + cmd_args, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _passthrough(args) -> list[str]:
    out = ["--workdir", args.workdir, "--n", str(args.n),
           "--seeds", str(args.seeds), "--fractions", args.fractions,
           "--heartbeats", str(args.heartbeats), "--groups",
           str(args.groups), "--timeout", str(args.timeout)]
    if args.device:
        out += ["--device", args.device]
    if args.conformance:
        out += ["--conformance"]
    return out


def _run(procs, timeout: float) -> tuple[bool, str]:
    ok, transcript = True, ""
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
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


def _strip_timing(artifact: dict) -> dict:
    out = {k: v for k, v in artifact.items() if k not in _TIMING_KEYS}
    out["trials"] = [{k: v for k, v in t.items() if k != "wall_s"}
                     for t in artifact["trials"]]
    return out


def main(args) -> int:
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="dcn_campaign_")
    os.makedirs(args.workdir, exist_ok=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    ok, transcript = _run([_spawn(["--worker", str(i)] + _passthrough(args),
                                  env) for i in range(NUM_PROCS)],
                          args.timeout)
    sys.stdout.write(transcript)
    if not ok:
        print("dcn_campaign_torch: FAIL (workers)")
        return 1
    ok, transcript = _run([_spawn(["--single"] + _passthrough(args), env)],
                          args.timeout)
    sys.stdout.write(transcript)
    if not ok:
        print("dcn_campaign_torch: FAIL (single-process run)")
        return 1

    with open(os.path.join(args.workdir, "dcn", "dcn_merged.json")) as f:
        dcn = json.load(f)
    with open(os.path.join(args.workdir, "single.json")) as f:
        ref = json.load(f)
    identical = _strip_timing(dcn) == _strip_timing(ref)
    dcn_tps = float(dcn["trials_per_s"])
    single_tps = float(ref["trials_per_s"])
    # two ranks on one core serialize whatever the orchestration does:
    # the ideal scaling is capped by the host's cores
    cores = os.cpu_count() or 1
    ideal = min(cores, NUM_PROCS) / NUM_PROCS
    result = {
        "bit_identical": identical,
        "trials": len(dcn["trials"]),
        "nproc": NUM_PROCS,
        "devs_per_proc": args.groups,
        "device": args.device or "cuda",
        "network_size": dcn["network_size"],
        "host_cores": cores,
        "ideal_scaling": ideal,
        "dcn_wall_s": dcn["wall_s"],
        "single_wall_s": ref["wall_s"],
        "dcn_trials_per_s": dcn_tps,
        "single_trials_per_s": single_tps,
        "scaling_efficiency": dcn_tps / single_tps,
        "scaling_efficiency_normalized": dcn_tps / single_tps / ideal,
        "honest_coverage_min": min(
            t["honest_coverage"] for t in dcn["trials"]),
    }
    with open(f"{args.out}.tmp", "w") as f:
        json.dump(result, f, allow_nan=False, sort_keys=True, indent=2)
    os.replace(f"{args.out}.tmp", args.out)
    print(f"dcn_campaign_torch: identical={identical} "
          f"efficiency={result['scaling_efficiency']:.3f} "
          f"dcn={dcn_tps:.3f}/s single={single_tps:.3f}/s")
    print("dcn_campaign_torch:", "PASS" if identical else "FAIL")
    return 0 if identical else 1


def _parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--fractions", default="0.0,0.2")
    ap.add_argument("--heartbeats", type=int, default=4)
    ap.add_argument("--groups", type=int, default=1,
                    help="trial groups per process (G of the 2 x G x 1 "
                    "grid)")
    ap.add_argument("--conformance", action="store_true",
                    help="attach the conformance certificate (rank 0 "
                    "computes it; its rank file carries it)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default cuda; cpu for the "
                    "CPU)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.worker is None and not args.single and not args.out:
        ap.error("--out is required")
    return args


if __name__ == "__main__":
    _args = _parse()
    if _args.worker is not None:
        worker(_args)
    elif _args.single:
        single(_args)
    else:
        sys.exit(main(_args))
