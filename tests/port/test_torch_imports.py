"""The port imports torch and never jax, flax or anything of the JAX
package: every module of dst_libp2p_test_node_tpu_torch (ops.mix,
runtime.multitopic, runtime.checkpoint, runtime.native_logemit, the
role workloads' ops.kad, ops.connmanager, ops.servicedisco,
runtime.kad_runtime, runtime.sd_runtime and runtime.regression_runtime,
and the service's runtime.metrics, runtime.supervise,
runtime.node_service, runtime.publisher and runtime.traffic, and the
campaign's ops.adversary, ops.repair, ops.telemetry, ops.faults,
ops.dht_adversary and runtime.campaign, the arena's ops.protocol and
ops.episub, the conformance gate's ops.spec, analysis.conformance
and runtime.profiling, and the tooling's native.tuned,
analysis.contracts, analysis.registry, analysis.report,
analysis.ast_lint, analysis.jaxpr_audit and runtime.microbench, and
the trial grid's parallel.sharding and parallel.ranks, and the peer
mesh's parallel.peer and runtime.sharded named), chip_smoke.py
and the port's scripts (scripts/dcn_smoke_torch.py,
scripts/dcn_campaign_torch.py and the validity, calibration and service
twins scripts/{attestation_anchor,eth_anchor,loss_modes_ab,
muxer_sensitivity,service_load}_torch.py; the shell twins run the port's
package only) import in a fresh interpreter where `import jax` and
`import flax` fail."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCRIPTS = ("dcn_smoke_torch.py", "dcn_campaign_torch.py",
           "attestation_anchor_torch.py", "eth_anchor_torch.py",
           "loss_modes_ab_torch.py", "muxer_sensitivity_torch.py",
           "service_load_torch.py")

_PROBE = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["flax"] = None
import dst_libp2p_test_node_tpu_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + ".") if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import runpy
for script in sys.argv[1:]:
    runpy.run_path(os.path.join("scripts", script), run_name="probe")
bad = sorted(m for m in sys.modules
             if m == "dst_libp2p_test_node_tpu"
             or m.startswith("dst_libp2p_test_node_tpu.")
             or m in ("jax", "flax") and sys.modules[m] is not None
             or m.startswith(("jax.", "jaxlib.", "flax.")))
print(len(names), "modules;", "leaked:", bad)
for name in ("ops.mix", "runtime.multitopic", "runtime.checkpoint",
             "runtime.native_logemit", "ops.kad", "ops.connmanager",
             "ops.servicedisco", "runtime.kad_runtime", "runtime.sd_runtime",
             "runtime.regression_runtime", "runtime.metrics",
             "runtime.supervise", "runtime.node_service",
             "runtime.publisher", "runtime.traffic", "ops.adversary",
             "ops.repair", "ops.telemetry", "ops.faults",
             "ops.dht_adversary", "runtime.campaign", "ops.protocol",
             "ops.episub", "ops.spec", "analysis.conformance",
             "runtime.profiling", "native.tuned", "analysis.contracts",
             "analysis.registry", "analysis.report", "analysis.ast_lint",
             "analysis.jaxpr_audit", "runtime.microbench",
             "parallel.sharding", "parallel.ranks", "parallel.peer",
             "runtime.sharded"):
    assert port.__name__ + "." + name in names, name
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE, *SCRIPTS],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def test_port_sources_name_no_jax_import():
    pkg = os.path.join(ROOT, "dst_libp2p_test_node_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "scripts", n) for n in SCRIPTS]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import flax", "from flax")), path
                assert not s.startswith(
                    ("import dst_libp2p_test_node_tpu ",
                     "from dst_libp2p_test_node_tpu ",
                     "from dst_libp2p_test_node_tpu.")), path


def test_shell_twins_run_the_port():
    for name in ("run_gpu.sh", "local_smoke_torch.sh"):
        with open(os.path.join(ROOT, "scripts", name)) as f:
            text = f.read()
        runs = [ln for ln in text.splitlines()
                if "-m dst_libp2p_test_node_tpu" in ln]
        assert runs and all("-m dst_libp2p_test_node_tpu_torch" in ln
                            for ln in runs), name
