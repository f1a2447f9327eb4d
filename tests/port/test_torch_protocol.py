"""The port's protocol registry (ops/protocol.py) against the reference's:

  - GossipSub's spec fields ARE the port's module-level runner objects
    (`is`), run_fused_rounds included, with no carry and no params;
  - episub is registered with its four runners, its controller, its
    params class and its two observables; the names, descriptions and
    observables equal the reference's specs;
  - an unknown name and a duplicate registration are refused as the
    reference refuses them;
  - the campaign's window resolver returns the GossipSub runner objects
    and refuses a protocol that carries its own ctrl."""

import dataclasses

import pytest

from dst_libp2p_test_node_tpu.ops import protocol as jproto
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import episub as tep
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops import heartbeat as thb
from dst_libp2p_test_node_tpu_torch.ops import protocol as tproto
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc

_DESCRIPTIVE = ("name", "repair_hook", "gossip_emission", "observables")


def test_gossipsub_fields_are_the_module_runner_objects():
    spec = tproto.get_protocol("gossipsub")
    assert spec.run_heartbeats is thb.run_heartbeats
    assert spec.run_attacked_heartbeats is tadv.run_attacked_heartbeats
    assert spec.run_adaptive_heartbeats is tadv.run_adaptive_heartbeats
    assert spec.run_faulted_heartbeats is tf.run_faulted_heartbeats
    assert spec.run_fused_rounds is td.run_fused_rounds
    assert spec.init_ctrl is None and spec.protocol_params is None


def test_episub_spec_carries_its_ctrl_and_observables():
    spec = tproto.get_protocol("episub")
    assert spec.run_heartbeats is tep.run_episub_heartbeats
    assert spec.run_attacked_heartbeats is tep.run_episub_attacked_heartbeats
    assert spec.run_adaptive_heartbeats is tep.run_episub_adaptive_heartbeats
    assert spec.run_faulted_heartbeats is tep.run_episub_faulted_heartbeats
    assert spec.run_fused_rounds is None
    assert spec.init_ctrl is tep.init_episub_ctrl
    assert spec.protocol_params is tep.EpisubParams
    assert spec.observables == ("tree_reach_frac", "tree_depth_mean")


@pytest.mark.parametrize("name", ["gossipsub", "episub"])
def test_specs_describe_what_the_reference_describes(name):
    want = jproto.get_protocol(name)
    got = tproto.get_protocol(name)
    for f in _DESCRIPTIVE:
        assert getattr(got, f) == getattr(want, f), f
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert tproto.protocol_names() == jproto.protocol_names() \
        == ["episub", "gossipsub"]


def test_unknown_and_duplicate_names_are_refused():
    for mod in (tproto, jproto):
        with pytest.raises(KeyError, match="unknown protocol 'plumtree'"):
            mod.get_protocol("plumtree")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_protocol(
                dataclasses.replace(mod.get_protocol("gossipsub")))
    with pytest.raises(ValueError, match="needs a name"):
        tproto.ProtocolSpec(
            name="", run_heartbeats=thb.run_heartbeats,
            run_attacked_heartbeats=thb.run_heartbeats,
            run_adaptive_heartbeats=thb.run_heartbeats,
            run_faulted_heartbeats=thb.run_heartbeats).validate()
    with pytest.raises(ValueError, match="run_faulted_heartbeats must be"):
        tproto.ProtocolSpec(
            name="x", run_heartbeats=thb.run_heartbeats,
            run_attacked_heartbeats=thb.run_heartbeats,
            run_adaptive_heartbeats=thb.run_heartbeats,
            run_faulted_heartbeats=None).validate()


def test_window_runner_resolves_gossipsub_and_refuses_a_ctrl_protocol():
    assert tc._protocol_window_runner(
        "gossipsub", "run_adaptive_heartbeats") is tadv.run_adaptive_heartbeats
    assert tc._protocol_window_runner(
        "gossipsub", "run_faulted_heartbeats") is tf.run_faulted_heartbeats
    for mod in (tc, jc):
        with pytest.raises(ValueError, match="'episub' carries a "
                           "per-protocol ctrl"):
            mod._protocol_window_runner("episub", "run_adaptive_heartbeats")
