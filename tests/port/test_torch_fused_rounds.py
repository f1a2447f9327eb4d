"""The port's round chains (ops/disseminate.run_fused_rounds) against the
reference, on the CPU:

  - the reference's five scenarios (mesh, three fragments, gossip-heavy
    message-mode loss, the adaptive attacker with the flight recorder, and
    the three fault families on a zero-attacker cohort), each with
    params.fused_rounds off and on: every state leaf, the controller,
    every stacked DisseminationResult leaf and every obs curve bitwise
    against the reference's phase-split output, and within the
    reference's own pins of its fused scan (ints, bools and delivery
    fields bitwise; floats rtol 1e-6 for the plain scenarios, 1e-5 for
    the adaptive, telemetry and fault ones: tests/test_fused_rounds.py);
  - the split chain is a loop over the public runners;
  - the reference's three argument refusals and the default controller."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops import heartbeat as thb
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel

torch.set_num_threads(1)

N = 32
PUBS = [3, 9, 17]
HB_PER_ROUND = 2
PAYLOAD = 15_000
SCORING = dict(slow_weight=-10.0, slow_decay=0.9, graylist_threshold=-50.0,
               gossip_threshold=-10.0, publish_threshold=-20.0)
FAULTS = dict(crash_frac=0.1, crash_window=(1, 4), partition_frac=0.3,
              partition_window=(1, 3), spike_frac=0.2, spike_window=(0, 4),
              spike_ms=50.0)
# the reference's pins of its fused scan against its split chain
RTOL = {"mesh": 1e-6, "frag": 1e-6, "gossip_heavy": 1e-6, "adaptive": 1e-5,
        "faults": 1e-5}


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _port_leaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


def _setup(scoring: bool):
    over = SCORING if scoring else {}
    g = build_connection_graph(N, 4, seed=0)
    pj = jst.SimParams(n=N, capacity=g.capacity, **over)
    pt = tst.SimParams(n=N, capacity=g.capacity, **over)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    topo = Topology.build(TopoParams(
        network_size=N, anchor_stages=3, min_bandwidth=50,
        max_bandwidth=150, min_latency=40, max_latency=130))
    host = (topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit)
    # warm heartbeats build a mesh first (the bench chain's convention)
    sj = jhb.run_heartbeats(jst.init_state(pj, seed=0), aj["conns"],
                            aj["rev"], aj["out_mask"], pj, 6)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    return dict(pj=pj, pt=pt, aj=aj, at=at, sj=sj, st=st,
                topo_j=tuple(jnp.asarray(x) for x in host),
                topo_t=tuple(torch.as_tensor(x) for x in host))


def _arms(scenario: str, lat_shape):
    """(reference kwargs, port kwargs) of run_fused_rounds."""
    if scenario == "frag":
        return dict(fragments=3), dict(fragments=3)
    if scenario == "gossip_heavy":
        # message-mode loss at 30%: the IHAVE/IWANT recovery is live
        return (dict(loss_mode="message",
                     loss_stage=jnp.full(lat_shape, 0.3, jnp.float32)),
                dict(loss_mode="message",
                     loss_stage=torch.full(lat_shape, 0.3)))
    if scenario == "adaptive":
        att = jadv.attacker_cohort(N, 0.25, seed=0)
        return (dict(attacker=jnp.asarray(att),
                     adv=jadv.AdversaryParams(
                         scenario="sybil_graft_flood",
                         adaptive=jadv.AdaptivePolicy(enabled=True)),
                     telemetry=jtel.TelemetryParams(record=True)),
                dict(attacker=torch.from_numpy(att),
                     adv=tadv.AdversaryParams(
                         scenario="sybil_graft_flood",
                         adaptive=tadv.AdaptivePolicy(enabled=True)),
                     telemetry=ttel.TelemetryParams(record=True)))
    if scenario == "faults":
        m = jf.fault_masks(N, jf.FaultParams(**FAULTS), seed=0,
                           publisher=PUBS[0])
        # a zero-attacker cohort: faults compose on the attack window
        att = jadv.attacker_cohort(N, 0.0, seed=0)
        return (dict(attacker=jnp.asarray(att), adv=jadv.AdversaryParams(),
                     faults=jf.FaultParams(**FAULTS),
                     **{k: jnp.asarray(v) for k, v in m.items()}),
                dict(attacker=torch.from_numpy(att),
                     adv=tadv.AdversaryParams(),
                     faults=tf.FaultParams(**FAULTS),
                     **{k: torch.from_numpy(v) for k, v in m.items()}))
    return {}, {}


def _flat(head, res, obs, adaptive: bool, port: bool):
    state, ctrl = head if adaptive else (head, None)
    if port:
        out = {"state/" + k: v
               for k, v in interop.state_to_numpy(state).items()}
        out.update({"res/" + k: v for k, v in _port_leaves(res).items()})
        if ctrl is not None:
            out.update({"ctrl/" + k: v
                        for k, v in interop.leaves_to_numpy(ctrl).items()})
        out.update({"obs/" + k: v
                    for k, v in interop.obs_to_numpy(obs).items()})
        return out
    out = {"state/" + k: v for k, v in _leaves(state).items()}
    out.update({"res/" + k: v for k, v in _leaves(res).items()})
    if ctrl is not None:
        out.update({"ctrl/" + k: v for k, v in _leaves(ctrl).items()})
    out.update({"obs/" + k: np.asarray(v) for k, v in obs.items()})
    return out


def _outside_pin(want: dict, got: dict, rtol: float) -> list:
    """Leaves of `got` outside the reference's fused-scan pin: ints and
    bools bitwise, floats within rtol (no atol, as the reference's
    assert_allclose)."""
    bad = sorted(set(want) ^ set(got))
    for k, a in want.items():
        b = got.get(k)
        if b is None or a.dtype != b.dtype or a.shape != b.shape:
            bad.append(k)
        elif a.dtype.kind in "biu":
            if a.tobytes() != b.tobytes():
                bad.append(k)
        elif not np.allclose(b, a, rtol=rtol, atol=0.0, equal_nan=True):
            bad.append(k)
    return bad


@pytest.mark.parametrize("scenario", ["mesh", "frag", "gossip_heavy",
                                      "adaptive", "faults"])
def test_rounds_match_reference(scenario):
    w = _setup(scoring=scenario in ("adaptive", "faults"))
    kw_j, kw_t = _arms(scenario, tuple(w["topo_j"][1].shape))
    args_j = (w["sj"], w["aj"]["conns"], w["aj"]["rev"], *w["topo_j"],
              w["aj"]["out_mask"], PUBS)
    args_t = (w["st"], w["at"]["conns"], w["at"]["rev"], *w["topo_t"],
              w["at"]["out_mask"], PUBS)
    adaptive = scenario == "adaptive"
    split = _flat(*jd.run_fused_rounds(*args_j, w["pj"], PAYLOAD,
                                       HB_PER_ROUND, **kw_j),
                  adaptive, port=False)
    fused = _flat(*jd.run_fused_rounds(
        *args_j, dataclasses.replace(w["pj"], fused_rounds=True), PAYLOAD,
        HB_PER_ROUND, **kw_j), adaptive, port=False)
    assert split["res/delay_ms"].shape == (len(PUBS), N)
    if adaptive:
        assert any(k.startswith("obs/adv_") for k in split)
        assert any(k.startswith("obs/tel_") for k in split)
    if scenario == "faults":
        assert {"obs/cross_mesh_edges",
                "obs/restarted_mean_degree"} <= set(split)
    for mode in (False, True):
        got = _flat(*td.run_fused_rounds(
            *args_t, dataclasses.replace(w["pt"], fused_rounds=mode),
            PAYLOAD, HB_PER_ROUND, **kw_t), adaptive, port=True)
        assert interop.leaf_mismatches(split, got) == [], mode
        assert sorted(set(split) ^ set(got)) == [], mode
        assert _outside_pin(fused, got, RTOL[scenario]) == [], mode
        if scenario in ("mesh", "frag", "gossip_heavy"):
            for f in ("received", "lost_tx", "answer_interleaved", "sends",
                      "copies_rx", "ihave_sent", "iwant_sent", "converged",
                      "refine_passes"):
                assert (fused["res/" + f].tobytes()
                        == got["res/" + f].tobytes()), f


def test_split_chain_is_the_public_runners():
    # the independent ground truth: a hand-written loop over the public
    # heartbeat runner and disseminate
    w = _setup(scoring=False)
    at = w["at"]
    stage, lat, bw = w["topo_t"]
    s_ref, ref = w["st"], []
    for pub in PUBS:
        s_ref = thb.run_heartbeats(s_ref, at["conns"], at["rev"],
                                   at["out_mask"], w["pt"], HB_PER_ROUND)
        r, s_ref = td.disseminate(
            s_ref, at["conns"], at["rev"], stage, lat, bw, publisher=pub,
            t0_ms=s_ref.t_ms, params=w["pt"], payload_bytes=PAYLOAD)
        ref.append(r)
    s2, r2, obs = td.run_fused_rounds(
        w["st"], at["conns"], at["rev"], stage, lat, bw, at["out_mask"],
        np.asarray(PUBS), w["pt"], PAYLOAD, HB_PER_ROUND)
    assert obs == {}
    assert interop.leaf_mismatches(interop.state_to_numpy(s_ref),
                                   interop.state_to_numpy(s2)) == []
    for f in dataclasses.fields(r2):
        want = torch.stack([getattr(r, f.name) for r in ref])
        assert torch.equal(want, getattr(r2, f.name)), f.name


def test_refusals_and_default_controller():
    w = _setup(scoring=True)
    at = w["at"]
    args = (w["st"], at["conns"], at["rev"], *w["topo_t"], at["out_mask"],
            PUBS[:1], w["pt"], PAYLOAD, HB_PER_ROUND)
    jargs = (w["sj"], w["aj"]["conns"], w["aj"]["rev"], *w["topo_j"],
             w["aj"]["out_mask"], PUBS[:1], w["pj"], PAYLOAD, HB_PER_ROUND)
    att = jadv.attacker_cohort(N, 0.25, seed=0)
    att_t = torch.from_numpy(att)
    static_t, static_j = tadv.AdversaryParams(), jadv.AdversaryParams()
    cases = [
        (dict(attacker=att_t), dict(attacker=jnp.asarray(att))),
        (dict(adv=static_t), dict(adv=static_j)),
        (dict(faults=tf.FaultParams(**FAULTS)),
         dict(faults=jf.FaultParams(**FAULTS))),
        (dict(attacker=att_t, adv=static_t,
              ctrl=tst.init_adaptive_ctrl(N, "cpu")),
         dict(attacker=jnp.asarray(att), adv=static_j,
              ctrl=jst.init_adaptive_ctrl(N))),
    ]
    for kw_t, kw_j in cases:
        with pytest.raises(ValueError) as te:
            td.run_fused_rounds(*args, **kw_t)
        with pytest.raises(ValueError) as je:
            jd.run_fused_rounds(*jargs, **kw_j)
        assert str(te.value) == str(je.value)
    # an armed policy without ctrl starts from a fresh controller
    armed = tadv.AdversaryParams(adaptive=tadv.AdaptivePolicy(enabled=True))
    (s1, c1), r1, o1 = td.run_fused_rounds(*args, attacker=att_t, adv=armed)
    (s2, c2), r2, o2 = td.run_fused_rounds(
        *args, attacker=att_t, adv=armed,
        ctrl=tst.init_adaptive_ctrl(N, "cpu"))
    assert interop.leaf_mismatches(interop.leaves_to_numpy(c1),
                                   interop.leaves_to_numpy(c2)) == []
    assert interop.leaf_mismatches(interop.state_to_numpy(s1),
                                   interop.state_to_numpy(s2)) == []
    assert interop.leaf_mismatches(interop.obs_to_numpy(o1),
                                   interop.obs_to_numpy(o2)) == []
    assert int(c1.regrafts.sum()) > 0
