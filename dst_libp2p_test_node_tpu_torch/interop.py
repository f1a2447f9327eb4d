"""State interchange with the reference engine, as numpy leaves.

`state_from_numpy` builds the port's SimState from a {leaf name: numpy
array} dict, such as the reference SimState's leaves converted with
np.asarray; `state_to_numpy` is the inverse. Leaf names and dtypes are the
same on both sides; the PRNG key travels as a (2,) uint32 array and is held
as int64 words in the port (prng.py). The tests use the pair to start both
engines from one state and compare them leaf by leaf. `leaves_to_numpy`
and `dataclass_from_numpy` do the same for the role workloads' state
(KadState, ConnState, AdvertStore), a campaign's carries (the adaptive
attacker's AdaptiveCtrl, a trial's KadState) and results. `obs_to_numpy` /
`obs_from_numpy` carry any {name: array} dict: a window's observable
curves, a trial's fault cohorts (ops/faults.fault_masks) or a DHT repair
pool under one name; `result_fields` / `campaign_from_fields` a
campaign's TrialResult and CampaignResult.
"""

from __future__ import annotations

import dataclasses

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


_WORD_LEAVES = ("key", "keys")


def leaves_to_numpy(obj) -> dict:
    """{field: numpy array} of a dataclass of arrays: one of the port's
    (KadState, ConnState, AdvertStore, a lookup result) or the reference's
    counterpart. PRNG keys and node keys come out as uint32 words on both
    sides."""
    out = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x))
        if f.name in _WORD_LEAVES:
            a = a.astype(np.uint32)
        out[f.name] = a
    return out


def dataclass_from_numpy(cls, leaves: dict, device):
    """The port's dataclass `cls` from {field: numpy array}, uint32 words
    of keys held as int64."""
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(leaves[f.name])
        if f.name in _WORD_LEAVES:
            a = a.astype(np.uint32).astype(np.int64)
        out[f.name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return cls(**out)


def obs_to_numpy(obs: dict) -> dict:
    """{key: numpy array} of a dict of arrays: a window's obs, fault
    cohorts or pools (tensors of the port or arrays of the reference)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in obs.items()}


def obs_from_numpy(obs: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v, order="C")).to(device)
            for k, v in obs.items()}


_WALL_FIELDS = ("wall_s", "trials_per_s")


def result_fields(obj, walls: bool = True) -> dict:
    """{field: value} of a TrialResult or CampaignResult of either package,
    trials as a list of such dicts; `walls=False` drops the wall-clock
    fields, which no two runs share."""
    if isinstance(obj, (list, tuple)):
        return [result_fields(x, walls) for x in obj]
    out = {}
    for f in dataclasses.fields(obj):
        if f.name in ("phase_walls", "rank_stats") or (
                not walls and f.name in _WALL_FIELDS):
            continue
        v = getattr(obj, f.name)
        if f.name == "trials":
            v = result_fields(v, walls)
        out[f.name] = v
    return out


def campaign_from_fields(fields: dict):
    """The port's CampaignResult from result_fields of either package."""
    from .runtime.campaign import CampaignResult, TrialResult

    d = dict(fields)
    d["trials"] = [TrialResult(**t) for t in d["trials"]]
    return CampaignResult(**d)
