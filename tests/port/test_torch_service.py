"""The port's resident node service (runtime/node_service.py,
runtime/supervise.py) against the reference, bitwise on the CPU:

  - PublishQueue operation sequences (tenant fairness, the depth cap, the
    device-time budget, deadline shedding, drain, snapshot/restore): equal
    batches, shed lists and snapshots;
  - NodeService driven by submit/pump with the same schedule, single- and
    multi-topic, batched and sequential: equal records, latency lines,
    counters and /metrics text outside the wall-clock series (the sojourn
    histogram and the dispatch EWMA);
  - the HTTP surface: 400, 404, 405, 500 for an unjoined topic, 429 with
    Retry-After, 503 while draining, /service and /telemetry (unarmed);
  - the flight recorder armed on the service's simulator: the /telemetry
    body (over HTTP, byte for byte) and the dst_sim_round_* series;
  - supervision: injected failures, a poison request bisected out of a
    batch, the watchdog's worker thread;
  - the service checkpoint: arrays equal to the reference's file, the
    sidecar equal outside the EWMA, restore across the two packages, and
    restore(mesh=) refused.

Every service binds port 0."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.env import NodeConfig as JNodeConfig
from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.runtime import multitopic as jmt
from dst_libp2p_test_node_tpu.runtime import node_service as jns
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch.config.env import NodeConfig as TNodeConfig
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt
from dst_libp2p_test_node_tpu_torch.runtime import node_service as tns
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim
from dst_libp2p_test_node_tpu_torch.runtime import supervise

torch.set_num_threads(1)

INF = float("inf")
# series whose values are host wall clock, not simulation
_WALL = ("dst_service_request_latency_ms", "dst_service_est_dispatch_ms")


# ------------------------------------------------------------ PublishQueue

def _queue_script(mod, script):
    """Run one operation script on a fresh queue; the observable trace."""
    q = mod.PublishQueue(max_depth=4, device_ms_budget=30.0)
    trace = []
    for op in script:
        if op[0] == "offer":
            _, tenant, size, deadline, est = op
            trace.append(q.offer(mod.PublishRequest(
                "t", size, tenant=tenant, deadline_ms=deadline), est_ms=est))
        elif op[0] == "take":
            batch, shed = q.take_batch(op[1], op[2])
            trace.append(([mod._req_to_json(r) for r in batch],
                          [mod._req_to_json(r) for r in shed]))
        elif op[0] == "drain":
            trace.append([mod._req_to_json(r) for r in q.drain()])
        elif op[0] == "snapshot":
            snap = q.snapshot()
            trace.append(snap)
            q = mod.PublishQueue(max_depth=4, device_ms_budget=30.0)
            q.restore(json.loads(json.dumps(snap)))
        trace.append((q.depth(), q.dropped))
    trace.append(q.snapshot())
    return trace


_SCRIPTS = {
    "fairness": [("offer", "a", 1, INF, 0.0), ("offer", "a", 2, INF, 0.0),
                 ("offer", "b", 3, INF, 0.0), ("offer", "c", 4, INF, 0.0),
                 ("take", 2, 0.0), ("offer", "b", 5, INF, 0.0),
                 ("take", None, 0.0), ("drain",)],
    "depth_cap": [("offer", "a", i, INF, 0.0) for i in range(6)]
    + [("take", 3, 0.0), ("offer", "b", 9, INF, 0.0), ("drain",)],
    "budget": [("offer", "a", 1, INF, 10.0), ("offer", "a", 2, INF, 10.0),
               ("offer", "b", 3, INF, 10.0), ("offer", "b", 4, INF, 0.0),
               ("take", 1, 0.0)],
    "deadline": [("offer", "a", 1, 50.0, 0.0), ("offer", "b", 2, 500.0, 0.0),
                 ("offer", "a", 3, INF, 0.0), ("offer", "c", 4, 99.0, 0.0),
                 ("take", 3, 100.0), ("take", 3, 1000.0)],
    "snapshot": [("offer", "x", 1, 70.0, 0.0), ("offer", "y", 2, INF, 0.0),
                 ("take", 1, 0.0), ("offer", "x", 3, INF, 0.0),
                 ("snapshot",), ("offer", "z", 4, INF, 0.0),
                 ("take", 2, 80.0), ("snapshot",), ("drain",)],
}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_publish_queue_sequences(name):
    assert _queue_script(tns, _SCRIPTS[name]) == \
        _queue_script(jns, _SCRIPTS[name])


def test_service_config_validation():
    for bad in (dict(max_queue_depth=0), dict(max_batch=0),
                dict(dispatch_mode="stacked"), dict(retry_backoff_s=-1.0),
                dict(max_retries=-1), dict(checkpoint_every=-2)):
        with pytest.raises(ValueError) as te:
            tns.ServiceConfig(**bad).validate()
        with pytest.raises(ValueError) as je:
            jns.ServiceConfig(**bad).validate()
        assert str(te.value) == str(je.value)


# --------------------------------------------------------------- services

_SINGLE = dict(topo=TopoParams(network_size=16, msg_size_bytes=500,
                               messages=1),
               connect_to=4, warmup_s=5.0, seed=3)
_MULTI = dict(topo=TopoParams(network_size=16, msg_size_bytes=400),
              topics=("blocks", "att_0", "att_1"), connect_to=4,
              warmup_s=5.0, seed=2, subscribe_fraction=0.75)


def _sims(kind):
    if kind == "single":
        j = jsim.Simulator(jsim.ExperimentConfig(**_SINGLE))
        t = tsim.Simulator(tsim.ExperimentConfig(**_SINGLE), device="cpu")
    else:
        j = jmt.MultiTopicSimulator(jmt.MultiTopicConfig(**_MULTI))
        t = tmt.MultiTopicSimulator(tmt.MultiTopicConfig(**_MULTI),
                                    device="cpu")
    for s in (j, t):
        s.warmup()
    return j, t


def _pair(kind, my_id=2, **svc_kw):
    j, t = _sims(kind)
    topic = "test" if kind == "single" else "blocks"
    js = jns.NodeService(
        j, JNodeConfig(my_id=my_id, network_size=16, connect_to=4,
                       topic=topic),
        control_port=0, metrics_port=0, service=jns.ServiceConfig(**svc_kw))
    ts = tns.NodeService(
        t, TNodeConfig(my_id=my_id, network_size=16, connect_to=4,
                       topic=topic),
        control_port=0, metrics_port=0, service=tns.ServiceConfig(**svc_kw))
    return js, ts


def _det(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_WALL))


def _records(sim):
    out = []
    for r in sim.records:
        topic, rec = r if isinstance(r, tuple) else (None, r)
        out.append((topic, int(rec.msg_id), float(rec.t0_ms),
                    np.asarray(rec.delays_ms).tobytes(),
                    np.asarray(rec.received).tobytes(),
                    np.asarray(rec.sends).tobytes()))
    return out


def _same_service(js, ts):
    assert _records(ts.sim) == _records(js.sim)
    assert ts.lines_out == js.lines_out
    assert ts.counters == js.counters
    assert ts.pump_rounds == js.pump_rounds
    assert ts.max_depth_seen == js.max_depth_seen
    assert ts.degraded == js.degraded
    assert ts.publishes.snapshot() == js.publishes.snapshot()
    assert _det(ts.metrics_text()) == _det(js.metrics_text())
    assert [x for x, _ in ts.latencies] == [x for x, _ in js.latencies]


def _schedule(kind):
    if kind == "single":
        return [[("test", 100, "a"), ("test", 300, "b"), ("test", 100, "c"),
                 ("test", 300, "a"), ("test", 100, "a")],
                [("test", 500, "b")], [],
                [("test", 100, "c"), ("test", 100, "c")]]
    return [[("blocks", 400, "blocks"), ("att_0", 400, "att"),
             ("att_1", 200, "att"), ("blocks", 200, "blocks"),
             ("att_0", 400, "att")],
            [("att_1", 400, "att"), ("att_0", 400, "att")],
            [("blocks", 400, "blocks")]]


def _drive(svcs, schedule, advance_ms=700.0, deadline=None):
    for tick in schedule:
        for svc in svcs:
            for topic, size, tenant in tick:
                mod = tns if isinstance(svc, tns.NodeService) else jns
                req = mod.PublishRequest(
                    topic, size, tenant=tenant,
                    deadline_ms=INF if deadline is None else deadline)
                code, body, hdr = svc.submit(req)
                svc._codes = getattr(svc, "_codes", []) + [(code, body, hdr)]
            svc.pump(advance_ms=advance_ms)


@pytest.mark.parametrize("kind,mode", [("single", "batched"),
                                       ("single", "sequential"),
                                       ("multi", "batched")])
def test_submit_pump_matches_reference(kind, mode):
    js, ts = _pair(kind, dispatch_mode=mode, max_batch=3, max_queue_depth=4)
    _drive((js, ts), _schedule(kind))
    assert ts._codes == js._codes
    assert any(c == 429 for c, _, _ in ts._codes)
    _same_service(js, ts)
    assert ts.service_status()["counters"] == js.service_status()["counters"]


def test_batched_equals_sequential():
    svcs = {}
    for mode in ("batched", "sequential"):
        _, svcs[mode] = _pair("multi", dispatch_mode=mode, max_batch=4)
    sched = _schedule("multi")
    for svc in svcs.values():
        _drive((svc,), sched)
    b, s = svcs["batched"], svcs["sequential"]
    assert _records(b.sim) == _records(s.sim)
    assert b.lines_out == s.lines_out
    assert (b.counters["device_dispatches"]
            < s.counters["device_dispatches"])


def test_deadlines_shed_before_dispatch():
    js, ts = _pair("single", max_batch=1, default_deadline_ms=900.0)
    _drive((js, ts), [[("test", 100, "a")] * 4, [], []],
           advance_ms=500.0)
    assert ts.counters["shed_deadline"] > 0
    _same_service(js, ts)


def test_injected_failure_and_poison_quarantine(monkeypatch):
    js, ts = _pair("multi", dispatch_mode="batched", max_batch=4,
                   inject_failures=1, max_retries=1, retry_backoff_s=0.0)
    _drive((js, ts), _schedule("multi")[:1])
    assert ts.degraded and (ts.counters["batch_splits"]
                            + ts.counters["retries"]) == 1
    _same_service(js, ts)
    # a poison topic: the batch bisects until only it is quarantined
    for svc in (js, ts):
        sim = svc.sim
        real_batch, real_pub = sim.publish_batch, sim.publish

        def batch_boom(items, _real=real_batch, **kw):
            if any(t == "att_1" for t, _ in items):
                raise RuntimeError("poison in batch")
            return _real(items, **kw)

        def pub_boom(topic, *a, _real=real_pub, **kw):
            if topic == "att_1":
                raise RuntimeError("poison request")
            return _real(topic, *a, **kw)

        monkeypatch.setattr(sim, "publish_batch", batch_boom)
        monkeypatch.setattr(sim, "publish", pub_boom)
    _drive((js, ts), [[("blocks", 400, "a"), ("att_1", 400, "a"),
                       ("att_0", 400, "a"), ("blocks", 400, "a")]])
    assert ts.counters["quarantined"] == 1
    assert ts.last_error == js.last_error
    _same_service(js, ts)


def test_watchdog_worker_and_abandoned_attempt():
    assert supervise._call_with_timeout(lambda: 7, 0.0, "cpu") == 7
    assert supervise._call_with_timeout(lambda: 8, 5.0, "cpu") == 8
    done = []

    def slow():
        time.sleep(0.3)
        done.append(1)

    import concurrent.futures as cf

    with pytest.raises(cf.TimeoutError):
        supervise._call_with_timeout(slow, 0.05, "cpu")
    time.sleep(0.5)
    assert done == [1]          # the abandoned attempt ran on to its end
    inj = supervise._FailureInjector(2)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            inj.maybe_fail()
    inj.maybe_fail()


def test_dispatch_timeout_runs_on_worker():
    js, ts = _pair("single", dispatch_timeout_s=60.0, max_batch=2)
    _drive((js, ts), _schedule("single")[:2])
    _same_service(js, ts)


# ------------------------------------------------------------------- HTTP

def _req(url, data=None, method=None):
    r = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _http_trace(svc):
    svc.start()
    try:
        c = f"http://127.0.0.1:{svc.control_port}"
        m = f"http://127.0.0.1:{svc.metrics_port}"
        pub = json.dumps({"topic": "test", "msgSize": 200}).encode()
        out = [
            _req(c + "/health"), _req(c + "/ready"), _req(c + "/nope"),
            _req(c + "/publish", b"{not json", "POST"),
            _req(c + "/publish", json.dumps({"topic": "test"}).encode(),
                 "POST"),
            _req(c + "/publish", json.dumps(
                {"topic": "other", "msgSize": 10}).encode(), "POST"),
            _req(c + "/publish", pub, "PUT"),
            _req(c + "/elsewhere", pub, "POST"),
            _req(m + "/nope"),
        ]
        out += [_req(c + "/publish", pub, "POST") for _ in range(3)]
        out.append(_req(c + "/publish", json.dumps(
            {"topic": "test", "msgSize": 200, "tenant": "x",
             "deadlineMs": 40}).encode(), "POST"))
        svc.pump(advance_ms=1000.0)
        status = json.loads(_req(c + "/service")[2])
        status.pop("est_dispatch_ms")
        out.append(status)
        out.append(json.loads(_req(c + "/telemetry")[2]))
        scrape = _req(m + "/metrics")
        out.append((scrape[0], scrape[1]["Content-Type"], _det(scrape[2])))
        svc.begin_drain()
        out.append(_req(c + "/publish", pub, "POST"))
        out.append(svc.service_status()["status"])
    finally:
        svc.stop()
    # headers that carry the server's clock or version are not compared
    return [(x[0], {k: v for k, v in x[1].items()
                    if k not in ("Date", "Server")}, x[2])
            if isinstance(x, tuple) and len(x) == 3 and isinstance(x[1], dict)
            else x for x in out]


def test_http_surface_matches_reference():
    js, ts = _pair("single", max_queue_depth=3, max_batch=8)
    got, want = _http_trace(ts), _http_trace(js)
    assert got == want
    codes = [x[0] for x in got if isinstance(x, tuple)]
    assert {400, 404, 405, 429, 500, 503} <= set(codes)
    r429 = next(x for x in got if isinstance(x, tuple) and x[0] == 429)
    assert r429[1]["Retry-After"] == "1"
    tel = next(x for x in got if isinstance(x, dict) and "armed" in x)
    assert tel["armed"] is False and tel["curves"] == {}


def test_armed_telemetry_window_matches_reference():
    from dst_libp2p_test_node_tpu.ops.telemetry import (
        TelemetryParams as JTel)
    from dst_libp2p_test_node_tpu_torch.ops.telemetry import (
        TelemetryParams as TTel)

    js, ts = _pair("single", max_batch=3)
    js.sim.record_telemetry(JTel(record=True))
    ts.sim.record_telemetry(TTel(record=True))
    _drive((js, ts), _schedule("single"), advance_ms=2000.0)
    _same_service(js, ts)
    assert "dst_sim_round_mesh_coverage" in ts.metrics_text()
    bodies = []
    for svc in (js, ts):
        svc.start()
        try:
            c = f"http://127.0.0.1:{svc.control_port}"
            bodies.append(_req(c + "/telemetry")[2])
        finally:
            svc.stop()
    assert bodies[1] == bodies[0]
    tel = json.loads(bodies[1])
    assert tel["armed"] is True and tel["heartbeats"] == 2
    assert len(tel["curves"]["tel_score_q"]) == 2
    assert all(len(v) == 2 for v in tel["curves"].values())


# ------------------------------------------------------------- checkpoint

def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_service_checkpoint_and_cross_restore(tmp_path):
    js, ts = _pair("multi", max_batch=2, max_queue_depth=8)
    _drive((js, ts), _schedule("multi")[:2])
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    js.flush_checkpoint(jp)
    ts.flush_checkpoint(tp)
    ja, ta = _npz(jp), _npz(tp)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        if k == "service_json":
            continue
        assert ja[k].dtype == ta[k].dtype and ja[k].tobytes() == \
            ta[k].tobytes(), k
    jm, tm_ = (json.loads(bytes(x["service_json"]).decode()) for x in (ja, ta))
    for meta in (jm, tm_):
        meta.pop("ewma_ms")
    assert jm == tm_
    # each package restores the other's file and goes on identically
    node = dict(my_id=2, network_size=16, connect_to=4, topic="blocks")
    svc_kw = dict(max_batch=2, max_queue_depth=8)
    jr = jns.NodeService.restore(tp, JNodeConfig(**node), control_port=0,
                                 metrics_port=0,
                                 service=jns.ServiceConfig(**svc_kw))
    tr = tns.NodeService.restore(jp, TNodeConfig(**node), control_port=0,
                                 metrics_port=0,
                                 service=tns.ServiceConfig(**svc_kw),
                                 device="cpu")
    assert tr.counters == jr.counters and tr.counters["restarts"] == 1
    assert _det(tr.metrics_text()) == _det(jr.metrics_text())
    _drive((jr, tr), _schedule("multi")[2:])
    _same_service(jr, tr)
    with pytest.raises(NotImplementedError, match="A13"):
        tns.NodeService.restore(tp, TNodeConfig(**node), mesh=object(),
                                device="cpu")


def test_enqueue_publish_and_metrics_persistence(tmp_path):
    js, ts = _pair("single", max_queue_depth=1)
    for svc, mod in ((js, jns), (ts, tns)):
        ns = svc.enqueue_publish(mod.PublishRequest("test", 200))
        assert ns == int(svc._sim_now() * 1e6)
        with pytest.raises(RuntimeError, match="not admitted"):
            svc.enqueue_publish(mod.PublishRequest("test", 200))
        svc.pump(advance_ms=500.0)
        d = tmp_path / type(svc).__module__.split(".")[0]
        d.mkdir()
        svc.store_metrics_loop(str(d), interval_s=0.01, stagger=False,
                               max_iters=2).join(timeout=10)
        svc._text = (d / "metrics_pod-2.txt").read_text()
    _same_service(js, ts)
    assert _det(ts._text) == _det(js._text)
    assert ts._text.count("# HELP dst_testnode_mesh_size") == 2
