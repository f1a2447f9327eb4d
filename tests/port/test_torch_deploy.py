"""The port's deployment (deploy/Dockerfile.torch, statefulset_torch.yaml,
build-job_torch.yaml), held statically: no image can be built in the
tests. Every COPY source exists; the entry point is the port's module;
neither file names the JAX package or jax as a module; the kernel build
calls the build function chip_smoke.py's phase 1 calls, and nothing
swallows its failure; the manifest's env names, ports and probe paths
equal the reference manifest's, under names of its own, and it asks for
one GPU."""

import glob
import json
import os
import re

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEPLOY = os.path.join(ROOT, "deploy")
NEW = ("Dockerfile.torch", "statefulset_torch.yaml", "build-job_torch.yaml")


def _read(name):
    with open(os.path.join(DEPLOY, name)) as f:
        return f.read()


def _instructions(text):
    """The Dockerfile's instructions as (KEYWORD, argument text), with
    continuation lines joined and comments dropped."""
    out, cur = [], ""
    for line in text.splitlines():
        s = line.strip()
        if not cur and (not s or s.startswith("#")):
            continue
        cur += " " + s.rstrip("\\").strip()
        if not s.endswith("\\"):
            key, _, arg = cur.strip().partition(" ")
            out.append((key.upper(), arg.strip()))
            cur = ""
    return out


def _docker():
    return _instructions(_read("Dockerfile.torch"))


def test_every_copy_source_exists():
    copies = [arg.split() for key, arg in _docker() if key == "COPY"]
    assert copies
    for *sources, _dest in copies:
        for src in sources:
            assert glob.glob(os.path.join(ROOT, src)), src


def test_entrypoint_is_the_port():
    inst = dict(_docker())
    assert json.loads(inst["ENTRYPOINT"]) == [
        "python", "-m", "dst_libp2p_test_node_tpu_torch"]
    assert json.loads(inst["CMD"]) == ["serve"]
    assert re.fullmatch(r"nvidia/cuda:12\.[\w.-]*devel[\w.-]*", inst["FROM"])
    assert "EXPOSE" in inst and inst["EXPOSE"].split() == [
        "5000", "8008", "8645"]


def test_no_jax_module_named():
    for name in NEW:
        text = _read(name)
        assert not re.search(r"\bjax\b|\bflax\b", text), name
        assert not re.search(r"dst_libp2p_test_node_tpu(?!_torch)", text), \
            name


def test_kernel_build_is_phase_1s_and_cannot_fail_silently():
    runs = [arg for key, arg in _docker() if key == "RUN"]
    build = [r for r in runs if "build.build()" in r]
    assert len(build) == 1
    assert ("from dst_libp2p_test_node_tpu_torch.native import build"
            in build[0])
    assert "native_logemit.load()" in build[0]
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        smoke = f.read()
    assert ("from dst_libp2p_test_node_tpu_torch.native import build"
            in smoke and "build.build()" in smoke)
    for r in runs:
        # each step gates the next with &&; no `|| true` (or any other
        # `||`) turns a failed build into a built image
        assert "||" not in r, r


def _manifest(name):
    docs = list(yaml.safe_load_all(_read(name)))
    svc = next(d for d in docs if d["kind"] == "Service")
    sts = next(d for d in docs if d["kind"] == "StatefulSet")
    return svc, sts, sts["spec"]["template"]["spec"]["containers"][0]


def _surface(svc, node):
    return {
        "env": [e["name"] for e in node["env"]],
        "service_ports": [(p["name"], p["port"])
                          for p in svc["spec"]["ports"]],
        "container_ports": [p["containerPort"] for p in node["ports"]],
        "ready": (node["readinessProbe"]["httpGet"]["path"],
                  node["readinessProbe"]["httpGet"]["port"]),
        "health": (node["livenessProbe"]["httpGet"]["path"],
                   node["livenessProbe"]["httpGet"]["port"]),
        "args": node["args"],
    }


def test_manifest_matches_the_reference_surface():
    rsvc, rsts, rnode = _manifest("statefulset.yaml")
    svc, sts, node = _manifest("statefulset_torch.yaml")
    assert _surface(svc, node) == _surface(rsvc, rnode)
    assert _surface(svc, node)["ready"] == ("/ready", 8645)
    assert _surface(svc, node)["health"] == ("/health", 8645)
    # names of its own, wired to each other
    assert svc["metadata"]["name"] != rsvc["metadata"]["name"]
    assert sts["metadata"]["name"] != rsts["metadata"]["name"]
    assert sts["spec"]["serviceName"] == svc["metadata"]["name"]
    env = {e["name"]: e["value"] for e in node["env"]}
    assert env["SERVICE"] == svc["metadata"]["name"]
    assert svc["spec"]["selector"]["app"] == \
        sts["spec"]["selector"]["matchLabels"]["app"]
    assert env["PEERS"] == str(sts["spec"]["replicas"])


def test_manifest_asks_for_one_gpu():
    _svc, _sts, node = _manifest("statefulset_torch.yaml")
    assert node["resources"]["limits"]["nvidia.com/gpu"] == 1


def test_build_job_builds_the_port_image():
    job = yaml.safe_load(_read("build-job_torch.yaml"))
    ref = yaml.safe_load(_read("build-job.yaml"))
    assert job["metadata"]["name"] != ref["metadata"]["name"]
    args = job["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--dockerfile=deploy/Dockerfile.torch" in args
    dest = next(a for a in args if a.startswith("--destination="))
    _svc, _sts, node = _manifest("statefulset_torch.yaml")
    assert dest.rsplit("/", 1)[1] == node["image"]
