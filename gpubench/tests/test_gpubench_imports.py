"""No run of the benchmark loads JAX or the JAX package, and the
reference loads neither them nor the port. Top-level module names (the
part before the first dot) are compared whole: the port's name begins
with the JAX package's and must pass."""

import ast
import json
import os
import subprocess
import sys

import pytest

from gpubench.harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "dst_libp2p_test_node_tpu"}
PORT = "dst_libp2p_test_node_tpu_torch"
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]

_RUN = r"""
import json, sys, tempfile, time
sys.path.insert(0, {root!r})
from gpubench import run
from gpubench.harness import judge, window
from gpubench.tests.tiny import tiny_cell
cell = tiny_cell(tempfile.mkdtemp(), {name!r}, messages=1)
r = window.run_cell(cell, 3, 0.05, True, "cpu", time.perf_counter())
run.per_layer(cell, r)
judge.check(cell, r.outputs, 3, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = r"""
import json, sys
sys.path.insert(0, {root!r})
from gpubench import control
from gpubench.harness import judge
from gpubench.tests.tiny import tiny_cell
import tempfile
cell = tiny_cell(tempfile.mkdtemp(), {name!r}, messages=1)
before = {{m.split(".")[0] for m in sys.modules}}
judge.reference_run(cell.config, cell.traffic, 3, "cpu")
control.readings(cell, 3, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}} - before)))
"""


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", CELLS)
def test_run_loads_no_jax(name):
    mods = _modules(_RUN.format(root=cells.ROOT, name=name))
    assert PORT in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_neither_jax_nor_the_port():
    mods = _modules(_REF.format(root=cells.ROOT, name=CELLS[0]))
    assert not mods & (FORBIDDEN | {PORT}), mods & (FORBIDDEN | {PORT})


def test_reference_sources_import_neither():
    ref = os.path.join(cells.HERE, "reference")
    for fname in sorted(os.listdir(ref)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ref, fname)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {PORT}, \
                    (fname, name)
