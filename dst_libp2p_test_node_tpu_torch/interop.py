"""State interchange with the reference engine, as numpy leaves.

`state_from_numpy` builds the port's SimState from a {leaf name: numpy
array} dict, such as the reference SimState's leaves converted with
np.asarray; `state_to_numpy` is the inverse. Leaf names and dtypes are the
same on both sides; the PRNG key travels as a (2,) uint32 array and is held
as int64 words in the port (prng.py). The tests use the pair to start both
engines from one state and compare them leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.state import SimState, leaf_names


def state_from_numpy(leaves: dict, device) -> SimState:
    missing = [k for k in leaf_names() if k not in leaves]
    if missing:
        raise KeyError(f"missing SimState leaves: {missing}")
    out = {}
    for k in leaf_names():
        a = np.asarray(leaves[k])
        if k == "key":
            a = a.astype(np.uint32).astype(np.int64)
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return SimState(**out)


def state_to_numpy(state: SimState) -> dict:
    out = {}
    for k in leaf_names():
        a = getattr(state, k).detach().cpu().numpy()
        if k == "key":
            a = a.astype(np.uint32)
        out[k] = a
    return out


def leaf_mismatches(want: dict, got: dict) -> list[str]:
    """Names of the leaves of `want` that `got` lacks or does not match
    bit for bit (same dtype, same shape, same bytes)."""
    bad = []
    for k, a in want.items():
        a = np.asarray(a)
        b = np.asarray(got.get(k)) if k in got else None
        if (b is None or a.dtype != b.dtype or a.shape != b.shape
                or a.tobytes() != b.tobytes()):
            bad.append(k)
    return bad
