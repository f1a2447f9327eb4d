"""Plain PyTorch reference of the GossipSub experiment the benchmark runs.

Written from the model's definition (the link model of the reference
engine's ops/disseminate.py docstring; the heartbeat transition of
ops/spec.py, the port's host model) and independent of the program: it
imports nothing of the port, reads none of its tables, and re-derives the
topology, the graph (graph.py), every draw (prng.py) and the state from
the seed. One object holds the whole experiment; `warmup`, `advance` and
`publish` mirror the calls the benchmark's window makes.

What it computes, and how it differs from the program's engines:

  heartbeat   the GRAFT / PRUNE / backoff / churn transition with the
              deferred score decay of one `advance` (float32, the spec's
              operation order), one step at a time.
  publish     per fragment, two phases (the first sender's back-edge
              leaves each peer's send order in the second), each solved
              by plain Jacobi iteration of the whole offer map from INF
              until a pass changes no bit: mesh offers, gossip IHAVE /
              IWANT answers (exact: each answering peer's jobs served by
              one single-server queue in IWANT-arrival order; bounded:
              unserialized), and the receiver's downlink clamp. No
              fast pipeline, no divergence test, no engine choice and no
              iteration cap of the program's size.
  accounting  the uplink and downlink drain times (bounded: the answer
              queue drained round by round) and the
              first-delivery credit, which later messages and heartbeats
              read.
  mix relay   the MIXD-hop Sphinx path and its occupancy-coupled delay.

Float times are float32 as the model states them; a number that only
rounding separates from the program's can differ in its last bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import graph, prng

INF = 3.4e38
BIG = 1e30
F32 = torch.float32


@dataclass(frozen=True)
class Model:
    """Every number the reference needs, read from a configuration file's
    "model" object (see `from_config`)."""

    n: int
    connect_to: int
    max_degree: int
    anchor_stages: int
    min_bandwidth: int
    max_bandwidth: int
    min_latency: int
    max_latency: int
    msg_size_bytes: int
    num_frags: int
    d: int
    d_low: int
    d_high: int
    d_score: int
    d_out: int
    d_lazy: int
    heartbeat_ms: float
    prune_backoff_ms: float
    gossip_factor: float
    history_gossip: int
    fmd_weight: float
    fmd_cap: float
    fmd_decay: float
    decay_to_zero: float
    proc_delay_ms: float
    mss_bytes: int
    initcwnd_segments: int
    idontwant_threshold_bytes: int
    churn_down_per_hb: float
    churn_up_per_hb: float
    serialize_answers: bool
    num_mix: int = 0
    mix_d: int = 4
    mix_proc_ms: float = 5.0
    mix_packet_bytes: int = 2413
    mix_body_bytes: int = 2048

    @classmethod
    def from_config(cls, cfg: dict) -> "Model":
        return cls(**cfg["model"])

    @property
    def churny(self) -> bool:
        return self.churn_down_per_hb > 0.0 or self.churn_up_per_hb > 0.0


def flights(nbytes: int, m: Model) -> int:
    """TCP slow-start flights of a cold transfer: initial window IW =
    initcwnd x MSS, doubling each round trip, counted until the bytes fit."""
    sent, count, cwnd = 0, 0, m.mss_bytes * m.initcwnd_segments
    while sent < nbytes:
        sent += cwnd
        cwnd *= 2
        count += 1
    return max(count, 1)


def stage_tables(m: Model):
    """(bandwidth Mbit/s per stage, latency ms per stage pair) of topogen's
    staged network: stage s has bandwidth min + s x jump, a pair (i, j)
    the latency of its farther stage, a stage with itself its own."""
    s = m.anchor_stages
    bw_jump = int((m.max_bandwidth - m.min_bandwidth) / s)
    lat_jump = int((m.max_latency - m.min_latency) / s)
    bw = [math.ceil(i * bw_jump + m.min_bandwidth) for i in range(s)]
    lat = np.zeros((s, s), dtype=np.float32)
    for i in range(s):
        for j in range(s):
            lo, hi = min(i, j), max(i, j)
            lat[i, j] = (max((s - lo) * lat_jump, m.min_latency) if lo == hi
                         else min(math.ceil((s - hi) * lat_jump
                                            + m.min_latency),
                                  m.max_latency))
    return np.asarray(bw, dtype=np.float32), lat


def _ranks(prio: torch.Tensor) -> torch.Tensor:
    """Each slot's position in its row's stable ascending order."""
    order = torch.argsort(prio, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _decay(x: torch.Tensor, scale: torch.Tensor, m: Model) -> torch.Tensor:
    eff = x * scale
    return torch.where(eff < m.decay_to_zero, 0.0, eff)


@dataclass
class Message:
    """One publish as the reference computes it."""

    delays_ms: np.ndarray     # (N,) float64, inf where never received
    received: np.ndarray      # (N,) bool
    mix_exit: int = -1
    mix_delay_ms: float = 0.0
    sweeps: int = 0           # Jacobi passes over every fixpoint
    converged: bool = True


class Experiment:
    """The seeded experiment: topology, graph and state on `device`."""

    def __init__(self, m: Model, seed: int, device, sweep_cap: int = 4000):
        self.m, self.seed, self.dev = m, int(seed), torch.device(device)
        self.sweep_cap = sweep_cap
        dev = self.dev
        conns, rev, out = graph.build(m.n, m.connect_to, self.seed,
                                      m.max_degree)
        self.graph_np = (conns, rev, out)
        self.conns = torch.as_tensor(conns, device=dev).long()
        self.rev = torch.as_tensor(rev, device=dev).long()
        self.out = torch.as_tensor(out, device=dev)
        self.slot_ok = (self.conns >= 0) & (self.rev >= 0)
        self.cl = self.conns.clamp_min(0)
        self.rl = self.rev.clamp_min(0)
        bw, lat = stage_tables(m)
        self.bw = torch.as_tensor(bw, device=dev)
        self.lat = torch.as_tensor(lat, device=dev)
        self.stage = torch.arange(m.n, device=dev) % m.anchor_stages
        self.lat_edge = torch.where(
            self.conns >= 0, self.lat[self.stage[:, None], self.stage[self.cl]],
            0.0)
        n, c = self.conns.shape
        key, k_phase = prng.split(prng.PRNGKey(self.seed, dev))
        self.st = {
            "mesh_mask": torch.zeros((n, c), dtype=torch.bool, device=dev),
            "backoff_until": torch.zeros((n, c), dtype=F32, device=dev),
            "fmd": torch.zeros((n, c), dtype=F32, device=dev),
            "alive": torch.ones((n,), dtype=torch.bool, device=dev),
            "subscribed": torch.ones((n,), dtype=torch.bool, device=dev),
            "hb_phase": prng.uniform(k_phase, (n,)) * m.heartbeat_ms,
            "uplink_free_ms": torch.zeros((n,), dtype=F32, device=dev),
            "rx_free_ms": torch.zeros((n,), dtype=F32, device=dev),
            "t_ms": torch.zeros((), dtype=F32, device=dev),
            "key": key,
        }
        self.hb_carry_ms = 0.0

    # ------------------------------------------------------------ helpers

    def pull(self, x: torch.Tensor, fill) -> torch.Tensor:
        """out[q, j] = x[conns[q, j], rev[q, j]]: what q's neighbor on slot
        j holds about q."""
        return torch.where(self.slot_ok, x[self.cl, self.rl], fill)

    def nbr(self, per_peer: torch.Tensor) -> torch.Tensor:
        return per_peer[self.cl] & self.slot_ok

    # ---------------------------------------------------------- heartbeat

    def advance(self, ms: float) -> None:
        carry = self.hb_carry_ms + ms
        steps = int(carry // self.m.heartbeat_ms)
        self.hb_carry_ms = carry - steps * self.m.heartbeat_ms
        if steps > 0:
            self.heartbeats(steps)

    def warmup(self, seconds: float) -> None:
        self.advance(seconds * 1000.0)

    def heartbeats(self, steps: int) -> None:
        """`steps` heartbeats; the score decay of the whole call is
        deferred to its end (two carried float32 scales), as one advance
        of the model does."""
        m, st = self.m, self.st
        f_sc = torch.ones((), dtype=F32, device=self.dev)
        for _ in range(steps):
            self._heartbeat(f_sc)
            f_sc = f_sc * m.fmd_decay
        st["fmd"] = _decay(st["fmd"], f_sc, m)

    def _heartbeat(self, f_sc: torch.Tensor) -> None:
        m, st = self.m, self.st
        n, c = self.conns.shape
        key, k_graft, k_keep, k_down, k_up = prng.split(st["key"], 5)
        t = st["t_ms"]
        alive = st["alive"]
        if m.churny:
            dies = prng.uniform(k_down, (n,)) < m.churn_down_per_hb
            revives = prng.uniform(k_up, (n,)) < m.churn_up_per_hb
            alive = torch.where(alive, ~dies, revives)
        sub = st["subscribed"]
        valid = ((self.conns >= 0) & alive[:, None] & self.nbr(alive & sub)
                 & sub[:, None])
        mesh = st["mesh_mask"] & valid
        deg = mesh.sum(dim=-1)
        scores = m.fmd_weight * torch.clamp_max(
            _decay(st["fmd"], f_sc, m), m.fmd_cap)
        need = torch.where(deg < m.d_low, m.d - deg, 0)
        if bool((need > 0).any()):
            eligible = (valid & ~mesh & (st["backoff_until"] <= t)
                        & (scores >= 0.0))
            prio = torch.where(eligible, prng.uniform(k_graft, (n, c)), BIG)
            grafted = (_ranks(prio) < need[:, None]) & eligible
            mesh = (mesh | grafted | self.pull(grafted, False)) & valid
        backoff = st["backoff_until"]
        over = mesh.sum(dim=-1) > m.d_high
        if bool(over.any()):
            rand = prng.uniform(k_keep, (n, c))
            top = (_ranks(torch.where(mesh, -scores + 1e-3 * rand, BIG))
                   < m.d_score) & mesh
            need_out = torch.clamp(
                m.d_out - (top & self.out).sum(dim=-1), 0, m.d)
            o_mask = mesh & self.out & ~top
            keep = top | ((_ranks(torch.where(o_mask, rand, BIG))
                           < need_out[:, None]) & o_mask)
            need_fill = torch.clamp(m.d - keep.sum(dim=-1), 0, m.d)
            f_mask = mesh & ~keep
            keep = keep | ((_ranks(torch.where(f_mask, rand, BIG))
                            < need_fill[:, None]) & f_mask)
            pruned = mesh & ~keep & over[:, None]
            by_peer = self.pull(pruned, False)
            backoff = torch.where(pruned | by_peer,
                                  t + m.prune_backoff_ms, backoff)
            mesh = mesh & ~pruned & ~by_peer
        st.update(mesh_mask=mesh, backoff_until=backoff, alive=alive,
                  t_ms=t + m.heartbeat_ms, key=key)

    # ------------------------------------------------------------ publish

    def publish(self, origin: int) -> Message:
        m, st = self.m, self.st
        t0 = float(st["t_ms"]) + self.hb_carry_ms
        publisher, mix_delay = origin, 0.0
        if m.num_mix:
            publisher, mix_delay = self._mix_relay(origin, t0)
        t_rx, received, sweeps, conv = self._disseminate(
            publisher, t0 + mix_delay)
        t_pub = torch.tensor(t0 + mix_delay, dtype=F32, device=self.dev)
        delay = torch.where(received, t_rx - t_pub, INF)
        delays = delay.double().cpu().numpy() + mix_delay
        rec = received.cpu().numpy()
        return Message(np.where(rec, delays, np.inf), rec,
                       mix_exit=publisher if m.num_mix else -1,
                       mix_delay_ms=mix_delay, sweeps=sweeps,
                       converged=conv)

    def _mix_relay(self, origin: int, t0: float):
        """MIXD distinct live mix nodes (ids below num_mix, not the
        origin) in the order of one uniform draw; each hop queues on the
        sender's uplink and the relay's downlink and writes both back."""
        m, st, dev = self.m, self.st, self.dev
        key, k_mix = prng.split(st["key"])
        ids = torch.arange(m.n, device=dev)
        ok = (ids < m.num_mix) & st["alive"] & (ids != origin)
        if int(ok.sum()) < m.mix_d:
            raise RuntimeError("mix network degraded")
        u = prng.uniform(k_mix, (m.n,))
        path = torch.argsort(torch.where(ok, u, 2.0)[:min(m.num_mix, m.n)],
                             stable=True)[:m.mix_d].tolist()
        hops_from = [origin] + path[:-1]
        packets = torch.ceil(torch.tensor(float(m.msg_size_bytes), dtype=F32)
                             / torch.tensor(float(m.mix_body_bytes),
                                            dtype=F32))
        wire = (packets * float(m.mix_packet_bytes)).to(dev)
        up, rx = st["uplink_free_ms"].clone(), st["rx_free_ms"].clone()
        ready = torch.tensor(t0, dtype=F32, device=dev)
        t_start = ready
        for a, b in zip(hops_from, path):
            sa, sb = self.stage[a], self.stage[b]
            tx = (wire * 8.0) / (self.bw[sa] * 1e6) * 1e3
            rx_hop = (wire * 8.0) / (self.bw[sb] * 1e6) * 1e3
            start = torch.maximum(ready, up[a])
            up[a] = start + tx
            done = torch.maximum(start + tx + self.lat[sa, sb],
                                 rx[b] + rx_hop)
            rx[b] = done
            ready = done + m.mix_proc_ms
        st.update(key=key, uplink_free_ms=up, rx_free_ms=rx)
        return path[-1], float(ready - t_start)

    def _disseminate(self, publisher: int, t0: float):
        """One message, every fragment: (t_rx (N,) f32, received (N,),
        Jacobi passes, converged); writes the state the message leaves."""
        m, st, dev = self.m, self.st, self.dev
        n, c = self.conns.shape
        conns, lat_e = self.conns, self.lat_edge
        key, k_rank, k_gossip = prng.split(st["key"], 3)
        frag = max(m.msg_size_bytes // m.num_frags, 16)
        bw_p = self.bw[self.stage]
        tx = torch.full((n,), frag * 8.0, dtype=F32, device=dev) / (
            bw_p * 1e6) * 1e3
        rx_const = st["rx_free_ms"] + tx          # downlink = uplink rate
        alive, sub = st["alive"], st["subscribed"]
        valid = (conns >= 0) & self.nbr(alive & sub)
        is_pub = torch.arange(n, device=dev) == publisher
        # flood publish: the publisher sends to every valid neighbor
        tgt = torch.where(is_pub[:, None], valid, st["mesh_mask"] & valid)
        rprio = torch.where(tgt, prng.uniform(k_rank, (n, c)), INF)
        g_cand = valid & ~tgt
        g_count = torch.clamp_min(
            m.gossip_factor * g_cand.sum(dim=-1).to(F32), float(m.d_lazy))
        kk = torch.ceil(g_count).long()
        rounds = m.history_gossip
        gw = []
        for k_h in prng.split(k_gossip, rounds):
            prio = torch.where(g_cand, prng.uniform(k_h, (n, c)), INF)
            srt = torch.sort(prio, dim=-1).values
            thr = torch.gather(srt, 1, kk.clamp(0, c - 1)[:, None])
            thr = torch.where(kk[:, None] >= c, INF, thr)
            gw.append(g_cand & (prio < thr))
        gw = torch.stack(gw)                                   # (H, N, C)
        g_off = torch.where(gw, torch.arange(rounds, dtype=F32, device=dev)
                            [:, None, None], float(rounds)).amin(dim=0) \
            * m.heartbeat_ms
        g_any = gw.any(dim=0)
        can_send = alive & sub
        up, phase = st["uplink_free_ms"], st["hb_phase"]
        hb = torch.tensor(m.heartbeat_ms, dtype=F32, device=dev)
        ans = 1.0 + 2.0 * float(flights(frag, m) - 1)
        ld_ans = lat_e * ans
        exact = m.serialize_answers

        def next_hb(t):
            return (torch.floor((t + m.proc_delay_ms - phase) / hb) + 1.0) \
                * hb + phase

        def gossip_queue(t):
            """Serialized answers at the estimate t: (offer (N, C), the
            edges whose IWANT came, the queue's drain). Each sampled
            (round, slot) job arrives at its IWANT time; requested jobs
            are served one tx each in arrival order (stable)."""
            live = can_send & (t < INF)
            q_t = t[self.cl]
            tick = next_hb(t)
            ws, reqs = [], []
            for h in range(rounds):
                a_h = torch.maximum(tick + h * m.heartbeat_ms, up)[:, None]
                samp = gw[h] & live[:, None]
                reqs.append(samp & (q_t > a_h + lat_e))
                ws.append(torch.where(samp, a_h + 2.0 * lat_e, INF))
            w, req = torch.cat(ws, dim=-1), torch.cat(reqs, dim=-1)
            perm = torch.argsort(w, dim=-1, stable=True)
            w_s = torch.gather(w, 1, perm)
            r_s = torch.gather(req, 1, perm).to(F32)
            cnt = torch.cumsum(r_s, dim=-1)
            txp = tx[:, None]
            mx = torch.cummax(torch.where(r_s > 0, w_s - (cnt - 1.0) * txp,
                                          -INF), dim=-1).values
            mx_prev = torch.cat([torch.full((n, 1), -INF, device=dev),
                                 mx[:, :-1]], dim=-1)
            cnt_prev = torch.cat([torch.zeros((n, 1), device=dev),
                                  cnt[:, :-1]], dim=-1)
            serve = torch.empty_like(w).scatter_(
                1, perm, torch.maximum(w_s, mx_prev + cnt_prev * txp))
            offer = (serve.reshape(n, rounds, c) + tx[:, None, None]
                     + ld_ans[:, None, :]).amin(dim=1)
            offer = torch.where(offer < INF, offer, INF)
            drain = torch.where(cnt[:, -1] > 0,
                                mx[:, -1] + cnt[:, -1] * tx, 0.0)
            return offer, req.reshape(n, rounds, c).any(dim=1), drain

        def round_drain(t):
            """Bounded delivery's uplink drain: each round's requested
            answers served one tx each in IWANT-arrival order, the rounds
            one after another, the uplink's busy time carried from one
            round to the next (exact delivery serves all rounds as one
            queue: gossip_queue)."""
            live = can_send & (t < INF)
            q_t = t[self.cl]
            tick = next_hb(t)
            busy = up
            had = torch.zeros((n,), dtype=torch.bool, device=dev)
            txp = tx[:, None]
            for h in range(rounds):
                a_h = torch.maximum(tick + h * m.heartbeat_ms, up)[:, None]
                req = gw[h] & live[:, None] & (q_t > a_h + lat_e)
                w_s, perm = torch.sort(
                    torch.where(req, a_h + 2.0 * lat_e, INF), dim=-1,
                    stable=True)
                r_s = torch.gather(req, 1, perm)
                cnt = torch.cumsum(r_s.to(F32), dim=-1)
                mx = torch.cummax(torch.where(r_s, w_s - (cnt - 1.0) * txp,
                                              -INF), dim=-1).values
                last = cnt[:, -1]
                busy = torch.where(last > 0.0, torch.maximum(busy, mx[:, -1])
                                   + last * tx, busy)
                had = had | (last > 0.0)
            return torch.where(had, busy, 0.0)

        def mesh_offers(t, rank, k, mask, f, ss, form):
            """Offer of every sender on every slot (sender-major): start
            + (queue + latency), each term rounded ("sum") or the two
            summed with one rounding ("fma"), or (start + queue) +
            latency ("attr"); the model fixes the rounding of each use."""
            start = torch.maximum(t + m.proc_delay_ms, up)
            slot = rank + 1.0 + f * k[:, None]
            queue = slot * tx[:, None]
            if form == "attr":
                off = start[:, None] + queue + lat_e * ss
            elif form == "fma":
                off = start[:, None] + (
                    slot.double() * tx[:, None].double()
                    + (lat_e * ss).double()).to(F32)
            else:
                off = start[:, None] + (queue + lat_e * ss)
            return torch.where(mask & can_send[:, None]
                               & (t < INF)[:, None], off, INF)

        def unserialized(t):
            live = (can_send & (t < INF))[:, None] & g_any
            return torch.where(
                live, torch.maximum(next_hb(t)[:, None] + g_off, up[:, None])
                + (2.0 * lat_e + ld_ans + tx[:, None]), INF)

        def solve(rank, k, mask, f, ss, t_pub, seed, form):
            """Jacobi passes of the whole offer map until one changes no
            bit; exact mode re-evaluates every answer queue each pass."""
            t = seed.clone()
            t[publisher] = t_pub
            for it in range(1, self.sweep_cap + 1):
                cand = mesh_offers(t, rank, k, mask, f, ss, form)
                cand = torch.minimum(cand, gossip_queue(t)[0] if exact
                                     else unserialized(t))
                best = self.pull(cand, INF).amin(dim=-1)
                t_new = torch.where(is_pub, t_pub,
                                    torch.maximum(best, rx_const))
                if not exact:
                    t_new = torch.minimum(t, t_new)
                if torch.equal(t_new, t):
                    return t, it, True
                t = t_new
            return t, self.sweep_cap, False

        def attribution(t, rank, k, mask, f, ss, form):
            """Incoming offers at the final times (receiver-major): mesh
            copies, and gossip answers (exact: the answered ones,
            serialized; bounded: every sampled edge, unserialized, as the
            fixpoint's own last pass offers them)."""
            mesh = mesh_offers(t, rank, k, mask, f, ss,
                               "attr" if exact else form)
            g, req, drain = gossip_queue(t)
            if not exact:
                drain = round_drain(t)
            gin = torch.where(req, g, INF) if exact else unserialized(t)
            return self.pull(torch.minimum(mesh, gin), INF), g, req, drain

        sweeps, conv = 0, True
        t_pubs = torch.tensor(t0, dtype=F32, device=dev) + torch.arange(
            m.num_frags, dtype=F32, device=dev) * tx[publisher]
        rank1 = _ranks(torch.where(tgt, rprio, INF)).to(F32)
        k1 = tgt.sum(dim=-1).to(F32)
        finals = []
        for f in range(m.num_frags):
            ss = 1.0 + 2.0 * float(flights((f + 1) * frag, m) - 1)
            fi = float(f)
            start = torch.full((n,), INF, device=dev)
            # the model's rounding: bounded phase 1 sums queue and
            # latency in one rounding, every other fixpoint in two
            form1 = "sum" if exact else "fma"
            t1, it1, ok1 = solve(rank1, k1, tgt, fi, ss, t_pubs[f], start,
                                 form1)
            inc1 = attribution(t1, rank1, k1, tgt, fi, ss, form1)[0]
            # the first sender's back-edge leaves the send order
            first = torch.argmin(inc1, dim=-1)
            got = ((inc1.amin(dim=-1) <= t1 + 0.01 + 1e-5 * t1)
                   & (t1 < INF) & ~is_pub)
            back = (torch.arange(c, device=dev) == first[:, None]) \
                & got[:, None]
            mask2 = tgt & ~back
            rm = got & tgt.gather(1, first[:, None])[:, 0]
            r0 = torch.where(rm, rank1.gather(1, first[:, None])[:, 0], INF)
            rank2 = rank1 - (rank1 > r0[:, None]).to(F32)
            k2 = k1 - rm.to(F32)
            t2, it2, ok2 = solve(rank2, k2, mask2, fi, ss, t_pubs[f], t1,
                                 "sum")
            inc2, g, req, drain = attribution(t2, rank2, k2, mask2, fi, ss,
                                              "sum")
            sweeps += it1 + it2
            conv = conv and ok1 and ok2
            finals.append((t2, rank2, k2, mask2, fi, ss, inc2, g, req, drain))
        t_all = torch.stack([x[0] for x in finals])
        received = (t_all < INF).all(dim=0)
        t_rx = torch.where(received, t_all.amax(dim=0), INF)
        self._write_back(finals, received, is_pub, valid, tx, key)
        return t_rx, received, sweeps, conv

    def _write_back(self, finals, received, is_pub, valid, tx, key):
        """The state a message leaves: each uplink busy until its last
        transmitted copy or answer, each downlink until its delivered
        copies drain one by one, and a first-message-delivery credit on
        the slot that delivered fragment 0."""
        m, st = self.m, self.st
        n, c = self.conns.shape
        up = st["uplink_free_ms"]
        idw = m.msg_size_bytes >= m.idontwant_threshold_bytes
        can_send = st["alive"] & st["subscribed"]
        up_new, arrivals = up, []
        for t, rank, k, mask, fi, ss, inc, g, req, drain in finals:
            start = torch.maximum(t + m.proc_delay_ms, up)
            live = (can_send & (t < INF))[:, None]
            mesh_ok = mask & live
            offered = mesh_ok | (live & (g < INF))
            if idw:
                # the target's IDONTWANT (sent on its own receipt) landed
                # before this slot's copy started: the copy is not sent
                send_at = start[:, None] + (rank + fi * k[:, None]) \
                    * tx[:, None]
                q_t = torch.where(self.slot_ok, t[self.cl], INF)
                offered = offered & ~((q_t + self.lat_edge < send_at) & mask)
            sent = offered & mask
            last = torch.where(sent, rank + 1.0, 0.0).amax(dim=-1)
            end = torch.where(last > 0.0,
                              start + (fi * k + last) * tx, 0.0)
            up_new = torch.maximum(up_new, torch.maximum(end, drain))
            copy = self.pull(sent | (req & offered), False)
            arrivals.append(torch.where(copy, inc, -INF))
        arr = torch.cat(arrivals, dim=-1)
        copies = (arr > -INF).sum(dim=-1).to(F32)
        desc = -torch.sort(-arr, dim=-1).values
        pos = torch.arange(arr.shape[1], dtype=F32, device=self.dev)
        fold = torch.where(pos[None, :] < copies[:, None],
                           desc + pos[None, :] * tx[:, None], -INF)
        rx_new = torch.maximum(st["rx_free_ms"] + copies * tx,
                               fold.amax(dim=-1))
        first = torch.argmin(finals[0][6], dim=-1)
        credit = (torch.arange(c, device=self.dev) == first[:, None]) \
            & (received & ~is_pub)[:, None]
        st.update(key=key, uplink_free_ms=up_new, rx_free_ms=rx_new,
                  fmd=torch.clamp_max(st["fmd"] + credit.to(F32),
                                      m.fmd_cap))
