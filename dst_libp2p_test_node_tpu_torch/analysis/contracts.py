"""Contract model of the port's entry-point registry (analysis/registry.py).

An EntrypointContract declares, once per hot entry point, what the
contract engine (analysis/jaxpr_audit.py), the profiler (runtime/
profiling.py) and the microbench harness (runtime/microbench.py) need:

  - ``build``: a zero-arg thunk returning a TraceSpec (fn + concrete small
    args on one device). Eager torch has no abstract trace, so every
    engine RUNS the spec: the registry's audit shapes (32-2,048 peers)
    keep that cheap.
  - ``feedback``: (out_get, arg_get) pairs for carried outputs (e.g. the
    new SimState fed back into the next publish). The output leaves must
    equal the argument leaves in dtype, shape and device (rule GA-J005's
    feedback half): an int32 leaf that comes back int64 is the torch form
    of the reference's aval drift.
  - ``runtime_check``: a thunk that runs the entry point on the canonical
    config and asserts value-level invariants in plain torch (the
    reference's checkify half).
  - ``retrace_budget``: the one-time work (nvcc builds, kernel library
    loads: runtime/profiling.count_retraces) a SECOND same-shape call may
    do. 0 for every shipped contract.
  - ``hbm_budget_bytes``: a ceiling on the call's device-memory rise
    (torch.cuda.max_memory_allocated) at the audit shape, and for a mesh
    contract on each rank's; None unbudgeted.
  - ``collectives``: the torch.distributed kinds (``all_gather``,
    ``all_reduce``, ``broadcast``) the entry point may run, None
    unchecked. The port's collectives are explicit (parallel/peer.py),
    so the sharding auditor (analysis/sharding_audit.py) reads the ones
    each rank ran, where the reference reads what GSPMD inserted.
  - ``collective_bytes_budget``: a ceiling on the bytes one rank's
    collectives move at the audit shape, None unbudgeted.
  - ``dcn_block_devices``: ranks per DCN block (the rank pool's ranks in
    blocks of this many, rank // block the block); with it every
    collective whose group spans two blocks counts against
    ``dcn_collective_bytes_budget``.
  - ``waivers``, ``notes``: as in the reference.

Left out of the reference's EntrypointContract, because they mean
something only to XLA: ``expected_conds`` (eager torch has no lax.cond to
elide: every branch is a Python branch on a host value), ``donate`` (no
buffer donation) and ``ladder`` / ``expected_compile_keys`` (no compile
key: nothing is compiled per shape). The reference's ``LadderRung`` goes
with ``ladder``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass
class TraceSpec:
    fn: Callable
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)

    def thunk(self) -> Callable[[], Any]:
        return lambda: self.fn(*self.args, **self.kwargs)


@dataclasses.dataclass
class EntrypointContract:
    name: str
    build: Callable[[], TraceSpec]
    # each pair: (output_getter(outputs) -> tree, arg_getter(spec) -> tree)
    feedback: list[tuple[Callable, Callable]] = dataclasses.field(
        default_factory=list)
    runtime_check: Callable[[], None] | None = None
    retrace_budget: int = 0
    hbm_budget_bytes: int | None = None
    collectives: frozenset | None = None
    collective_bytes_budget: int | None = None
    dcn_block_devices: int | None = None
    dcn_collective_bytes_budget: int = 0
    waivers: tuple = ()
    notes: str = ""


# the torch.distributed kinds a contract's `collectives` may name
COLLECTIVE_KINDS = ("all_gather", "all_reduce", "broadcast")

_WORD_LEAVES = ("key", "keys")


def leaves(tree, prefix: str = "", strict: bool = True) -> dict:
    """{path: leaf} of a result tree: tensors, arrays (anything with
    __array__, so the reference's jax arrays too) and Python scalars, under
    dataclass fields, namedtuple fields, dict keys and tuple / list
    indices. None is skipped; any other object raises, or with
    `strict=False` is skipped too. Paths name the same leaf in the
    reference's tree and the port's."""
    out: dict = {}

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, torch.Tensor) or hasattr(x, "__array__") or \
                isinstance(x, (bool, int, float, str, np.generic)):
            out[path] = x
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}" if path
                     else f.name)
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for name in x._fields:
                walk(getattr(x, name), f"{path}.{name}" if path else name)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}.{k}" if path else str(k))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif strict:
            raise TypeError(f"no leaf rule for {type(x).__name__} at "
                            f"{path or '<root>'}")

    walk(tree, prefix)
    return out


def numpy_leaves(tree) -> dict:
    """leaves() as host numpy arrays; PRNG keys and node keys as uint32
    words (the port holds them as int64, the reference as uint32)."""
    out = {}
    for path, x in leaves(tree).items():
        a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x))
        if path.rsplit(".", 1)[-1] in _WORD_LEAVES:
            a = a.astype(np.uint32)
        out[path] = a
    return out


def tensor_bytes(*trees) -> int:
    """Bytes of the distinct tensors (by storage) in the trees."""
    seen = set()
    total = 0
    for tree in trees:
        for x in leaves(tree, strict=False).values():
            if isinstance(x, torch.Tensor):
                key = (x.device, x.untyped_storage().data_ptr())
                if key not in seen:
                    seen.add(key)
                    total += x.numel() * x.element_size()
    return total
