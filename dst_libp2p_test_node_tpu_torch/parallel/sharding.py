"""Device grids for Monte-Carlo campaigns: the trial and DCN parts of the
reference's parallel/sharding.py.

A campaign's trials are independent, so between trial groups a grid
needs no tensor collective: each group is its own rank processes
(parallel/ranks.py), and only host objects come back. A group P devices
wide is P ranks that split each trial's peer rows and run the same
per-trial path on their row blocks, exchanging rows over the group's own
subgroup (parallel/peer.py): the reference's nested windows. The grid is
a small frozen dataclass, not a jax Mesh: the reference's axis names
mapped to sizes (`shape`) and the torch.devices of every trial group.

  make_trial_mesh   ("trials", "peers"): one process's trial groups
  make_dcn_mesh     ("dcn", "trials", "peers"): one block per process of
                    a torch.distributed world, each block that process's
                    trial groups (every host alike)

The defaults follow the reference and count CUDA devices: one group per
visible GPU, and a group count must divide the device count. `devices=`
may list a device more than once and may list "cpu": that is how a grid
of G ranks runs on one card or on the CPU.

The peer half (the 1-D "peers" mesh) is a PeerMesh: the devices of one
rank process each, the torch.distributed backend they join (NCCL when
every rank has a distinct CUDA device, gloo otherwise; `backend=`
overrides), and the rank pool (parallel/ranks.py) that runs them.
Simulator(mesh=) and MultiTopicSimulator(mesh=) drive it
(runtime/sharded.py). The placers split host arrays into the ranks' row
blocks: peer_sharding / replicated name the two layouts, reshard_rows
splits one leaf, place_simulation checks the reference's divisibility
rule and shard_simulation splits a whole simulation.

The nested placers split a stacked trial batch (leaves with a leading
trial axis) over a grid's ranks, rank g*P + p holding trial block g:
trial_sharding (that block, whole rows), nested_sharding (that block,
row block p of a peer-major leaf), peer_submesh_sharding (row block p of
a trial-invariant (N, ...) leaf, every group alike); nested_batch_shardings
picks one per leaf by the reference's shape rule and place_trial_batch
places a batch and its shared graph (runtime/campaign.py's nested windows
run them). tree_map walks the port's trees (dicts, tuples, lists and
dataclasses of tensors or arrays). Inside `recording_placements()` every
nested window notes the placement it used, leaf by leaf
(describe_placement: global and per-rank bytes, partitions per dim,
whether every running rank holds the whole leaf), for the sharding
auditor (analysis/sharding_audit.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

TRIAL_AXIS = "trials"
DCN_AXIS = "dcn"
PEER_AXIS = "peers"

@dataclass(frozen=True)
class DeviceGrid:
    """A trial grid: axis names with their sizes, and this process's trial
    groups, each the tuple of its devices (one device each unless the
    peer axis is wider)."""

    axis_names: tuple
    sizes: tuple
    groups: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def group_devices(self) -> list:
        """The device of each trial group (a grid one device wide per
        group; a wider one has rank_devices)."""
        if peers_per_group(check_trial_grid(self)) > 1:
            raise ValueError(
                f"a grid {peers_per_group(self)} devices wide per group has "
                "no one device per group: use rank_devices")
        return [g[0] for g in self.groups]

    @property
    def rank_devices(self) -> list:
        """Every device of the grid, group by group: rank g*P + p's."""
        return [d for g in self.groups for d in g]


def _visible_devices(platform: str | None, n_devices: int | None,
                     devices) -> list:
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif platform in (None, "cuda", "gpu"):
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif platform == "cpu":
        devs = [torch.device("cpu")] * (1 if n_devices is None
                                        else n_devices)
    else:
        raise ValueError(f"platform {platform!r} not in (cuda, cpu)")
    if n_devices is not None:
        devs = devs[:n_devices]
    return devs


def audit_trial_groups(n_devices: int | None = None) -> int:
    """Trial-group count of the audit grids: GRAFT_AUDIT_TRIAL_GROUPS if
    set (it must divide the device count), else 2 on two or more devices
    and 1 on one."""
    nd = torch.cuda.device_count() if n_devices is None else n_devices
    env = os.environ.get("GRAFT_AUDIT_TRIAL_GROUPS", "")
    if env:
        groups = int(env)
        if groups < 1 or nd % groups != 0:
            raise ValueError(
                f"GRAFT_AUDIT_TRIAL_GROUPS={groups} must divide the device "
                f"count {nd} evenly")
        return groups
    return 2 if nd >= 2 else 1


def make_trial_mesh(trial_groups: int | None = None,
                    n_devices: int | None = None,
                    platform: str | None = None,
                    devices=None) -> DeviceGrid:
    """The 2-D trials x peers grid over the visible CUDA devices (or
    `devices`, or `platform="cpu"`'s n_devices CPU entries): axis 0
    deals a fraction's seed column over `trial_groups` groups, every
    remaining device widening each group's peer submesh. The default is
    one group per device."""
    devs = _visible_devices(platform, n_devices, devices)
    if trial_groups is None:
        trial_groups = len(devs)
    if trial_groups < 1 or len(devs) % trial_groups != 0:
        raise ValueError(
            f"trial_groups {trial_groups} must divide the device count "
            f"{len(devs)} evenly")
    per_group = len(devs) // trial_groups
    groups = tuple(tuple(devs[g * per_group:(g + 1) * per_group])
                   for g in range(trial_groups))
    return DeviceGrid((TRIAL_AXIS, PEER_AXIS), (trial_groups, per_group),
                      groups)


def process_count() -> int:
    """Processes of the torch.distributed world (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def make_dcn_mesh(dcn: int | None = None,
                  trial_groups: int | None = None,
                  n_devices: int | None = None,
                  platform: str | None = None,
                  devices=None) -> DeviceGrid:
    """The 3-level dcn x trials x peers grid: axis 0 is one block per
    process (dcn defaults to the world size), and every block is one
    host's devices, so only trial-axis work spans processes. Each
    process lists its own block's devices (every host alike), split into
    `trial_groups` groups (2 when the block has two or more devices)."""
    devs = _visible_devices(platform, n_devices, devices)
    if dcn is None:
        dcn = process_count()
    if dcn < 1:
        raise ValueError(f"dcn {dcn} must be >= 1")
    per_block = len(devs)
    if trial_groups is None:
        trial_groups = 2 if per_block >= 2 else 1
    if trial_groups < 1 or per_block % trial_groups != 0:
        raise ValueError(
            f"trial_groups {trial_groups} must divide the per-block device "
            f"count {per_block} evenly")
    local = make_trial_mesh(trial_groups, devices=devs)
    return DeviceGrid((DCN_AXIS,) + local.axis_names,
                      (dcn,) + local.sizes, local.groups)


def local_trial_submesh(mesh: DeviceGrid) -> DeviceGrid:
    """This process's trials x peers block of a make_dcn_mesh grid; the
    identity on a grid without a dcn axis."""
    if DCN_AXIS not in mesh.axis_names:
        return mesh
    return DeviceGrid(mesh.axis_names[1:], mesh.sizes[1:], mesh.groups)


def peers_per_group(mesh: DeviceGrid) -> int:
    """Width of the peer submesh inside each trial group."""
    return int(mesh.shape.get(PEER_AXIS, 1))


def check_trial_grid(mesh) -> DeviceGrid:
    """`mesh` as a grid the campaign can run: a make_trial_mesh (or
    make_dcn_mesh) DeviceGrid, of any width per trial group."""
    if not isinstance(mesh, DeviceGrid):
        raise TypeError(
            f"trial_mesh must be a make_trial_mesh grid, got "
            f"{type(mesh).__name__}")
    return mesh


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         timeout_s: float = 3600.0) -> int:
    """Join a multi-process campaign (the DCN engine): one gloo
    torch.distributed group over every process. `coordinator_address` is
    "host:port" (TCP) or an init URL ("file:///path" for a FileStore);
    the arguments default to torch's env:// variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK). Returns this process's rank."""
    import datetime

    import torch.distributed as dist

    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(
        "gloo", init_method=url or "env://", world_size=(
            -1 if num_processes is None else num_processes),
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


# every payload is padded to lanes of this width: back-to-back reduces of
# different widths can overlap across ranks on an oversubscribed host, and
# one width keeps every message the same size (the reference's reason)
_DCN_LANES = 4


def dcn_allreduce(vec, op: str = "sum") -> np.ndarray:
    """All-reduce a small per-process host vector over every process of the
    torch.distributed world ("sum" or "max"); the identity without one.
    Every process must reach it, so it doubles as a barrier. Returns the
    reduced vector as float32 numpy."""
    import torch.distributed as dist

    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    vec = np.asarray(vec, np.float32).reshape(-1)
    if not dist.is_initialized():
        return vec.copy()
    size = vec.size
    width = max(_DCN_LANES, -(-size // _DCN_LANES) * _DCN_LANES)
    fill = np.float32(0.0 if op == "sum" else -np.inf)
    padded = np.full(width, fill, np.float32)
    padded[:size] = vec
    t = torch.from_numpy(padded)
    dist.all_reduce(t, op=(dist.ReduceOp.SUM if op == "sum"
                           else dist.ReduceOp.MAX))
    return t.numpy()[:size]


class PeerMesh:
    """The 1-D peer mesh: one rank process per entry of `devices` (a
    device may repeat: two ranks can share one card) joined over
    `backend`. The rank pool starts on first use and serves every
    Simulator built on this mesh until `close`."""

    axis_names = (PEER_AXIS,)

    def __init__(self, devices, backend: str, threads: int | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a peer mesh needs at least one device")
        self.backend = backend
        self.threads = threads
        self._pool = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {PEER_AXIS: self.size}

    @property
    def pool(self):
        """The mesh's parallel/ranks.RankPool (started on first job)."""
        if self._pool is None:
            from .ranks import RankPool

            self._pool = RankPool(self.devices, threads=self.threads,
                                  backend=self.backend)
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()

    def __enter__(self) -> "PeerMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"PeerMesh({[str(d) for d in self.devices]}, "
                f"{self.backend})")


def peer_backend(devices) -> str:
    """NCCL when every device is a distinct CUDA device, gloo otherwise
    (ranks sharing a card, CPU ranks): the fixed rule of make_peer_mesh."""
    devs = [torch.device(d) for d in devices]
    distinct = len({str(d) for d in devs}) == len(devs)
    cuda = all(d.type == "cuda" for d in devs)
    return "nccl" if cuda and distinct and len(devs) > 0 else "gloo"


def make_peer_mesh(n_devices: int | None = None,
                   platform: str | None = None, devices=None,
                   backend: str | None = None,
                   threads: int | None = None) -> PeerMesh:
    """1-D peer mesh over the visible CUDA devices (or `devices`, which
    may repeat one, or `platform="cpu"`'s n_devices CPU ranks), one rank
    process each. The backend follows peer_backend unless `backend`
    names one; NCCL refuses two ranks on one GPU, so there is no other
    rule and no retry. The chosen backend is printed on stderr.
    `threads`: CPU threads per rank."""
    import sys

    devs = _visible_devices(platform, n_devices, devices)
    if not devs:
        raise ValueError("no device for a peer mesh")
    chosen = peer_backend(devs) if backend is None else backend
    if chosen not in ("gloo", "nccl"):
        raise ValueError(f"backend {chosen!r} not in (gloo, nccl)")
    if chosen == "nccl" and peer_backend(devs) != "nccl":
        raise ValueError(
            "nccl needs every rank on a distinct CUDA device, got "
            f"{[str(d) for d in devs]}")
    print(f"peer mesh: {len(devs)} ranks on {[str(d) for d in devs]} "
          f"over {chosen}", file=sys.stderr, flush=True)
    return PeerMesh(devs, chosen, threads=threads)


def check_peer_mesh(mesh) -> PeerMesh:
    """`mesh` as a peer mesh the Simulators can run on."""
    if not isinstance(mesh, PeerMesh):
        raise TypeError(
            f"mesh must be a make_peer_mesh PeerMesh, got "
            f"{type(mesh).__name__}")
    return mesh


@dataclass(frozen=True)
class RowSharding:
    """Rows of an (N, ...) leaf split evenly over `parts` ranks."""

    parts: int

    def split(self, x) -> list:
        n = x.shape[0]
        if n % self.parts != 0:
            raise ValueError(
                f"peer rows {n} must divide evenly over {self.parts} "
                "devices")
        per = n // self.parts
        return [x[r * per:(r + 1) * per] for r in range(self.parts)]


@dataclass(frozen=True)
class Replicated:
    """The same value on each of `parts` ranks."""

    parts: int

    def split(self, x) -> list:
        return [x] * self.parts


def peer_sharding(mesh) -> RowSharding:
    """Rows of any (N, ...) peer-major array split across the mesh."""
    return RowSharding(check_peer_mesh(mesh).size)


def replicated(mesh) -> Replicated:
    return Replicated(check_peer_mesh(mesh).size)


def reshard_rows(x, mesh) -> list:
    """One (N, ...) leaf as the ranks' row blocks, in rank order."""
    return peer_sharding(mesh).split(x)


def place_simulation(state, arrays, stage, lat, bw, loss, mesh) -> list:
    """The reference's constructor-side placement: the row-axis
    divisibility check, then shard_simulation of the state, the graph
    arrays and the topology (stage rows split, the stage matrices
    replicated). Returns one (state, arrays, stage, lat, bw, loss) per
    rank."""
    n_rows = state.mesh_mask.shape[0]
    if n_rows % check_peer_mesh(mesh).size != 0:
        raise ValueError(
            f"peer rows {n_rows} must divide evenly over {mesh.size} "
            "devices")
    topo = {"stage": stage, "lat": lat, "bw": bw}
    if loss is not None:
        topo["loss"] = loss
    return [(st, ar, tp["stage"], tp["lat"], tp["bw"], tp.get("loss"))
            for st, ar, tp in shard_simulation(state, arrays, topo, mesh)]


def shard_simulation(state, arrays: dict, topo: dict, mesh) -> list:
    """One (state, arrays, topo) per rank: every leaf whose leading axis
    is the state's peer rows split by rows, the rest (scalars, the clock,
    the key, the stage matrices) replicated."""
    import dataclasses

    n = state.mesh_mask.shape[0]
    rows, rep = peer_sharding(mesh), replicated(mesh)

    def split(x):
        peer_major = getattr(x, "ndim", 0) >= 1 and x.shape[0] == n
        return (rows if peer_major else rep).split(x)

    leaves = {f.name: split(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    arr = {k: split(v) for k, v in arrays.items()}
    tp = {k: split(v) for k, v in topo.items()}
    return [(state.replace(**{k: v[r] for k, v in leaves.items()}),
             {k: v[r] for k, v in arr.items()},
             {k: v[r] for k, v in tp.items()})
            for r in range(mesh.size)]


# ------------------------------------------------------------ nested grids


def tree_map(fn, tree, *rest):
    """fn over the tensor / array leaves of the port's trees (dicts,
    tuples, lists, dataclasses), `rest` trees of the same structure
    alongside; None and other values pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def grid_shape(mesh) -> tuple[int, int]:
    """(trial groups, ranks per group) of a make_trial_mesh grid or of an
    open parallel/ranks.RankPool."""
    from .ranks import RankPool

    if isinstance(mesh, RankPool):
        return mesh.groups, mesh.peer_width
    grid = local_trial_submesh(check_trial_grid(mesh))
    return int(grid.shape[TRIAL_AXIS]), peers_per_group(grid)


def _blocks(n: int, parts: int, what: str) -> int:
    if n % parts != 0:
        raise ValueError(f"{what} {n} must divide evenly over {parts}")
    return n // parts


@dataclass(frozen=True)
class TrialSharding:
    """A stacked (T, ...) leaf over a grid's ranks: rank g*P + p holds
    trial block g (T / G trials), its rows whole."""

    groups: int
    width: int

    def split(self, x) -> list:
        per = _blocks(x.shape[0], self.groups, "stacked trials")
        return [x[g * per:(g + 1) * per] for g in range(self.groups)
                for _ in range(self.width)]


@dataclass(frozen=True)
class NestedSharding:
    """A stacked peer-major (T, N, ...) leaf over a grid's ranks: rank
    g*P + p holds trial block g, row block p."""

    groups: int
    width: int

    def split(self, x) -> list:
        per = _blocks(x.shape[0], self.groups, "stacked trials")
        rows = _blocks(x.shape[1], self.width, "peer rows")
        return [x[g * per:(g + 1) * per, p * rows:(p + 1) * rows]
                for g in range(self.groups) for p in range(self.width)]


@dataclass(frozen=True)
class SubmeshRows:
    """A trial-invariant (N, ...) leaf over a grid's ranks: rank g*P + p
    holds row block p, in every group alike."""

    groups: int
    width: int

    def split(self, x) -> list:
        rows = _blocks(x.shape[0], self.width, "peer rows")
        return [x[p * rows:(p + 1) * rows] for _ in range(self.groups)
                for p in range(self.width)]


def trial_sharding(mesh) -> TrialSharding:
    """Leading-axis (stacked-trial) placement over a grid's trial groups
    (on a make_dcn_mesh grid, this process's groups)."""
    return TrialSharding(*grid_shape(mesh))


def nested_sharding(mesh) -> NestedSharding:
    """Both-axes placement of stacked peer-major leaves (T, N, ...):
    trials over the groups, peer rows over each group's ranks."""
    return NestedSharding(*grid_shape(mesh))


def peer_submesh_sharding(mesh) -> SubmeshRows:
    """Peer-row placement of a trial-invariant (N, ...) leaf over each
    group's ranks (the epoch graph every trial shares)."""
    return SubmeshRows(*grid_shape(mesh))


def nested_batch_shardings(tree, mesh, n_rows: int):
    """The placement of every leaf of a stacked trial batch, by the
    reference's shape rule: axis 1 == the peer row count -> nested (state
    rows, attacker and fault masks, carries, per-trial graphs); anything
    else with a leading trial axis -> trial_sharding (the clock, the PRNG
    key, curves)."""
    nested, rows = nested_sharding(mesh), trial_sharding(mesh)
    return tree_map(
        lambda x: nested if x.ndim >= 2 and x.shape[1] == n_rows else rows,
        tree)


def place_trial_batch(stacked, shared: dict, mesh, n_rows=None) -> list:
    """One stacked trial batch and its shared graph dict placed on a
    grid's ranks: a (stacked, shared) pair per rank, in rank order. With
    `n_rows` the placement is nested (nested_batch_shardings; the shared
    (N, ...) arrays split by rows over each group, the rest whole);
    without it each group's ranks get its trial block and every shared
    array whole (the reference's trial-only layout)."""
    groups, width = grid_shape(mesh)
    size = groups * width
    if n_rows is None:
        rows = trial_sharding(mesh)
        plan = tree_map(lambda x: rows, stacked)
    else:
        plan = nested_batch_shardings(stacked, mesh, n_rows)
    sub = peer_submesh_sharding(mesh)
    out = []
    for r in range(size):
        st = tree_map(lambda x, sp, r=r: sp.split(x)[r], stacked, plan)
        sh = {k: (sub.split(v)[r] if n_rows is not None
                  and getattr(v, "ndim", 0) >= 1 and v.shape[0] == n_rows
                  else v) for k, v in shared.items()}
        out.append((st, sh))
    return out


def tree_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] of the tensor / array leaves of a tree, in tree_map's
    order: dict keys as `.k`, sequence items as `[i]`, dataclass fields as
    `.f`."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += tree_paths(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += tree_paths(v, f"{prefix}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out += tree_paths(getattr(tree, f.name), f"{prefix}.{f.name}")
    return out


def _nbytes(x) -> int:
    return int(math.prod(x.shape)) * (x.element_size()
                                      if isinstance(x, torch.Tensor)
                                      else x.itemsize)


def describe_placement(stacked_args: tuple, shared: dict, placed: list,
                       active: list) -> list:
    """One dict per input leaf of a nested window: `name` (`args[i]...`
    for the stacked trial arguments, `shared.k` for the shared graph),
    its global `shape` and `global_bytes`, the bytes each running rank
    holds (`rank_bytes`, in the order of `active`), `partitions_per_dim`
    (the global extent over a running rank's extent, per dim) and
    `replicated`: more than one rank runs the window and every one of
    them holds the whole leaf. `placed`: place_trial_batch's per-rank
    (args, shared) pairs; `active`: the ranks that run the window."""
    whole = tree_paths(tuple(stacked_args), "args") + tree_paths(
        {k: shared[k] for k in sorted(shared)}, "shared")
    pieces = [dict(tree_paths(tuple(placed[r][0]), "args") + tree_paths(
        {k: placed[r][1][k] for k in sorted(placed[r][1])}, "shared"))
        for r in active]
    out = []
    for name, x in whole:
        held = [p[name] for p in pieces]
        first = held[0] if held else x
        parts = [(g // s) if s else 1
                 for g, s in zip(x.shape, first.shape)] or [1]
        rank_bytes = [_nbytes(h) for h in held]
        out.append({
            "name": name, "shape": [int(d) for d in x.shape],
            "global_bytes": _nbytes(x), "rank_bytes": rank_bytes,
            "partitions_per_dim": [int(p) for p in parts],
            "replicated": len(active) > 1 and all(
                b == _nbytes(x) for b in rank_bytes)})
    return out


_PLACEMENTS: list | None = None


@contextlib.contextmanager
def recording_placements():
    """Within the block every nested window appends its
    describe_placement list to the list this yields."""
    global _PLACEMENTS
    prev, _PLACEMENTS = _PLACEMENTS, []
    try:
        yield _PLACEMENTS
    finally:
        _PLACEMENTS = prev


def note_placement(stacked_args: tuple, shared: dict, placed: list,
                   active: list) -> None:
    """A nested window's placement, kept while recording_placements()
    is open (nothing is computed otherwise)."""
    if _PLACEMENTS is not None:
        _PLACEMENTS.append(describe_placement(stacked_args, shared, placed,
                                              active))
