"""Rank jobs of the peer-mesh tests (tests/port/test_torch_peer_*.py):
module-level functions a RankPool sends by import path, kept apart from
the test modules so a rank does not import the JAX package."""

import os

import numpy as np
import torch

from dst_libp2p_test_node_tpu_torch.parallel import exchange as tex
from dst_libp2p_test_node_tpu_torch.parallel import peer

_ORDER = ("conns", "rev", "lat_edge", "tx_ms", "rank", "k_p", None,
          "send_mask", "can_send", "g_tgt", "g_off", "hb_phase", "uplink",
          "rx_const")


def converge_rows(payload, device):
    """build_recv_constants and converge_sharded on this rank's rows of a
    scenario: returns the local (t, inc, converged) and the collectives."""
    import torch.distributed as dist

    sc, frag_idx, with_gossip, packed, max_iters, t0, g_floor, proc, hb = \
        payload
    grp = peer.PeerGroup(dist.get_rank(), dist.get_world_size(),
                         sc["conns"].shape[0], device)
    with peer.using(grp):
        args = [torch.tensor(frag_idx) if k is None
                else torch.from_numpy(grp.local(sc[k]).copy())
                for k in _ORDER]
        cst = tex.build_recv_constants(*args, proc, hb, with_gossip,
                                       packed=packed)
    t_l, floor = tex.place_sharded(
        grp, t0, t0 if g_floor is None else g_floor)
    t, inc, ok = tex.converge_sharded(
        t_l, cst, max_iters, grp, g_floor=None if g_floor is None else floor)
    return t.numpy(), inc.numpy(), ok, dict(grp.stats)


def die_in_a_collective(payload, device):
    """Rank 1 exits while rank 0 waits in an all-gather with it."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        os._exit(3)
    grp = peer.PeerGroup(dist.get_rank(), dist.get_world_size(), 4, device)
    return grp.all_rows(torch.zeros(2)).numpy()


def rows_of(payload, device):
    """This rank's rows [r0, r1) of an N-row mesh."""
    import torch.distributed as dist

    grp = peer.PeerGroup(dist.get_rank(), dist.get_world_size(), payload,
                         device)
    return np.arange(grp.r0, grp.r1)


def fused_chain(params, payload_bytes, hb_per_round, publishers, st, sh):
    """run_fused_rounds of one trial on this rank's rows (a nested
    window's body, runtime/campaign._run_nested_window): (state, (the
    results with every peer's rows, obs))."""
    import dataclasses

    from dst_libp2p_test_node_tpu_torch.ops import disseminate as td

    head, res, obs = td.run_fused_rounds(
        st, sh["conns"], sh["rev"], sh["stage"], sh["lat"], sh["bw"],
        sh["out_mask"], publishers, params, payload_bytes, hb_per_round)
    rows = {k: peer.all_rows(getattr(res, k).transpose(0, 1).contiguous())
            .transpose(0, 1) for k in td.RESULT_ROWS}
    return head, (dataclasses.replace(res, **rows), obs)


def rows_helpers(payload, device):
    """peer.prefix_rows and peer.add_rows on this rank's rows of whole
    arrays: (the prefixes gathered, this rank's rows after the add)."""
    import torch.distributed as dist

    x, idx, val, prefixes = payload
    grp = peer.PeerGroup(dist.get_rank(), dist.get_world_size(),
                         x.shape[0], device)
    with peer.using(grp):
        mine = torch.from_numpy(grp.local(x).copy())
        got = [peer.prefix_rows(mine, m).numpy() for m in prefixes]
        added = peer.add_rows(mine, torch.from_numpy(idx),
                              torch.from_numpy(val))
    return got, added.numpy(), dict(grp.stats)
