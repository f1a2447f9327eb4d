"""The port's disseminate(return_plan=True), the seam of the independent
discrete-event cross-check (tests/test_des_crosscheck.py), against the
reference on the CPU: every plan leaf bitwise (its 13 keys, None where the
reference has None) on the cross-check's cases (fragments x loss x flood /
gossip-only, tcp retransmission, the fanout publisher with and without
loss, the graylist gate, bounded mode and both answer-queue modes of exact
mode), the result and new state the same bytes as the reference's and as
the port's own publish without the flag, and for two cases the port's
arrival times against the cross-check's event-queue model run on the
port's plan."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst

torch.set_num_threads(1)

_DES_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "test_des_crosscheck.py")
_spec = importlib.util.spec_from_file_location("_des_crosscheck", _DES_PATH)
des = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(des)

PLAN_KEYS = ("tgt", "rprio", "g_tgt_w", "survive", "retx_ms", "hb_phase",
             "uplink", "rx_free", "rx_ms", "can_send", "tx_ms", "lat_edge",
             "t_pubs")


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _tleaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


def _both(n, ct, seed, stages, *, publisher, loss=0.0, loss_mode="message",
          frags=1, gossip_only=False, unsub=None, over=None, slow=None,
          payload=15000):
    """One publish through both engines from the cross-check's set-up;
    returns (JAX result/state/plan, port result/state/plan, port state in,
    call args of the port)."""
    over = dict(over or {})
    g, pj, sj, a, (stage, lat, bw) = des._setup(n, ct, seed, stages, **over)
    if gossip_only:
        sj = sj.replace(mesh_mask=jnp.zeros_like(sj.mesh_mask))
    if unsub is not None:
        sub = np.ones(n, bool)
        sub[unsub] = False
        sj = sj.replace(subscribed=jnp.asarray(sub))
    if slow is not None:
        sj = sj.replace(slow_penalty=jnp.asarray(slow))
    loss_j = (jnp.full((stages + 1, stages + 1), loss, jnp.float32)
              if loss > 0 else None)
    kw = dict(publisher=publisher, t0_ms=float(sj.t_ms), payload_bytes=payload,
              fragments=frags, with_gossip=True, loss_mode=loss_mode,
              with_fanout=unsub is not None)
    rj, nj, plan_j = jd.disseminate(sj, a["conns"], a["rev"], stage, lat, bw,
                                    params=pj, loss_stage=loss_j,
                                    return_plan=True, **kw)
    pt = tst.SimParams(**{f.name: getattr(pj, f.name)
                          for f in dataclasses.fields(pj)})
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    at = tst.graph_arrays(g, "cpu")
    targs = (st, at["conns"], at["rev"], torch.from_numpy(np.array(stage)),
             torch.from_numpy(np.array(lat)),
             torch.from_numpy(np.array(bw)))
    tkw = dict(kw, params=pt, loss_stage=(
        None if loss_j is None else torch.from_numpy(np.array(loss_j))))
    rt, nt, plan_t = td.disseminate(*targs, return_plan=True, **tkw)
    return (rj, nj, plan_j), (rt, nt, plan_t), (g, pj, targs, tkw)


CASES = {
    # the cross-check's (n, connect_to, seed, stages) and options
    "flood": ((64, 5, 0, 1), dict(publisher=0)),
    "lossy": ((64, 5, 2, 3), dict(publisher=2, loss=0.2)),
    "frags_lossy": ((64, 5, 4, 2), dict(publisher=4, loss=0.2, frags=3)),
    "no_flood": ((64, 5, 5, 3), dict(publisher=5,
                                     over=dict(flood_publish=False))),
    "gossip_only": ((64, 5, 6, 2), dict(publisher=6, loss=0.2,
                                        gossip_only=True,
                                        over=dict(flood_publish=False))),
    "tcp": ((64, 5, 41, 2), dict(publisher=41, loss=0.3, frags=3,
                                 loss_mode="tcp")),
    "fanout": ((128, 8, 23, 3), dict(publisher=5, unsub=5,
                                     over=dict(flood_publish=False))),
    "fanout_tcp": ((96, 7, 47, 3), dict(publisher=11, unsub=11, loss=0.2,
                                        loss_mode="tcp",
                                        over=dict(flood_publish=False))),
    "graylist": ((96, 7, 24, 2), dict(publisher=9, over=dict(
        slow_weight=-1.0, graylist_threshold=-50.0))),
    "bounded": ((128, 8, 70, 3), dict(publisher=9, loss=0.15,
                                      gossip_only=True, over=dict(
                                          flood_publish=False,
                                          serialize_answers=False))),
    "serial_queue": ((64, 5, 2, 3), dict(publisher=2, loss=0.2, over=dict(
        flood_publish=False, d_lazy=12, answer_queue_mode="serial"))),
}


def _graylist_slow(n, ct, seed):
    """The cross-check's graylist fixture: a third of the peers score peer
    9 below the threshold."""
    g = des.build_connection_graph(n, ct, seed=seed)
    conns = np.asarray(g.conns)
    rng = np.random.default_rng(5)
    slow = np.zeros(conns.shape, np.float32)
    for r in rng.choice(n, size=32, replace=False):
        slow[r, conns[r] == 9] = 100.0
    return slow


def _case(name):
    (n, ct, seed, stages), kw = CASES[name]
    if name == "graylist":
        kw = dict(kw, slow=_graylist_slow(n, ct, seed))
    return _both(n, ct, seed, stages, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_leaves_bitwise(name):
    td.reset_engine_counts()
    (rj, nj, pj), (rt, nt, pt), _ = _case(name)
    route = {"bounded": None, "serial_queue": "serial"}.get(name, "prefix")
    if route is not None:
        assert td.engine_counts[route] == 1
    assert sorted(pt) == sorted(PLAN_KEYS) == sorted(pj)
    for k in PLAN_KEYS:
        if pj[k] is None:
            assert pt[k] is None, k
            continue
        a, b = np.asarray(pj[k]), pt[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert interop.leaf_mismatches(_leaves(rj), _tleaves(rt)) == []
    assert interop.leaf_mismatches(_leaves(nj),
                                   interop.state_to_numpy(nt)) == []
    if name in ("tcp", "fanout_tcp"):
        assert (pt["retx_ms"] > 0).any()
    if name == "graylist":
        assert pt["survive"].dim() == 2 and not bool(pt["survive"].all())
    if name == "frags_lossy":
        assert pt["survive"].shape[0] == 3 and pt["t_pubs"].shape == (3,)


@pytest.mark.parametrize("name", ["frags_lossy", "serial_queue",
                                  "fanout_tcp"])
def test_plan_is_a_side_output(name):
    """The flag adds the plan and changes no result or state byte."""
    _, (rt, nt, _), (_, _, targs, tkw) = _case(name)
    r2, n2 = td.disseminate(*targs, **tkw)
    assert interop.leaf_mismatches(_tleaves(rt), _tleaves(r2)) == []
    assert interop.leaf_mismatches(interop.state_to_numpy(nt),
                                   interop.state_to_numpy(n2)) == []


@pytest.mark.parametrize("name", ["lossy", "tcp"])
def test_port_times_match_the_event_queue_on_its_plan(name):
    _, (rt, _, plan), (g, pj, targs, tkw) = _case(name)
    des._compare(rt, plan, targs[1].numpy(), targs[2].numpy(), pj,
                 tkw["publisher"], tkw["t0_ms"], tkw["fragments"])
