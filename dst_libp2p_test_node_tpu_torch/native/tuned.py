"""Launch tuning table of the port's two CUDA kernels.

The reference's table (dst_libp2p_test_node_tpu/native/tuned.py) holds a
Pallas row block per kernel. The port's kernels have no row block: each
entry names the launch parameter its CUDA kernel really has,

    {"vmem_gather": {"blocks_per_sm": 2}, "score_update": {"threads": 256}}

the persistent blocks per SM of csrc/vmem_gather.cu and the threads per
block of csrc/score_update.cu. The microbench harness (runtime/
microbench.py) sweeps both and writes the winners here with `--install`.

The wrappers (native/vmem_gather.py, native/score_update.py) take an
override keyword first, then this table, then their built-in constants
(2 blocks per SM, 256 threads). The table is OPTIONAL and advisory, as the
reference's is: a missing file, malformed JSON or an entry that is not a
positive int (a bool is not one) inside the kernel's range is ignored, so
shipping no table, the default, changes no launch. An override outside
the range raises instead. The search path is `DST_TUNED_JSON` when set,
else `tuned.json` next to this module.
"""

from __future__ import annotations

import functools
import json
import os

_ENV = "DST_TUNED_JSON"

# kernel -> the launch parameter its table entry names
PARAMS = {"vmem_gather": "blocks_per_sm", "score_update": "threads"}


def tuned_path() -> str:
    return (os.environ.get(_ENV)
            or os.path.join(os.path.dirname(__file__), "tuned.json"))


@functools.cache
def _load() -> dict:
    try:
        with open(tuned_path()) as fh:
            table = json.load(fh)
        return table if isinstance(table, dict) else {}
    except (OSError, ValueError):
        return {}


def invalidate_cache() -> None:
    """Drop the cached table (microbench re-reads after writing it)."""
    _load.cache_clear()


def usable(value, lo: int, hi: int, multiple: int = 1) -> bool:
    """True for an int (not a bool) in [lo, hi] that `multiple` divides."""
    return (isinstance(value, int) and not isinstance(value, bool)
            and lo <= value <= hi and value % multiple == 0)


def tuned_launch(kernel: str, lo: int, hi: int,
                 multiple: int = 1) -> int | None:
    """The tuned launch parameter of `kernel`, or None when the table has
    no usable entry (see `usable`): the caller then keeps its constant."""
    entry = _load().get(kernel)
    if not isinstance(entry, dict):
        return None
    value = entry.get(PARAMS[kernel])
    return value if usable(value, lo, hi, multiple) else None
