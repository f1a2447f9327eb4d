"""The port's launch tuning table (native/tuned.py) and the wrappers'
launch-parameter overrides, on the CPU: the reference's
test_tuned_table_lookup_and_fallbacks cases (tests/test_score_kernel.py)
against the port's table, whose entries name the CUDA kernels' real
launch parameters (vmem_gather's blocks per SM, score_update's threads
per block)."""

import json

import pytest
import torch

from dst_libp2p_test_node_tpu_torch.native import score_update as su
from dst_libp2p_test_node_tpu_torch.native import tuned
from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
from dst_libp2p_test_node_tpu_torch.ops.state import SimParams

CPU = torch.device("cpu")


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("DST_TUNED_JSON", str(path))
    tuned.invalidate_cache()

    def write(obj):
        path.write_text(obj if isinstance(obj, str) else json.dumps(obj))
        tuned.invalidate_cache()

    yield write
    tuned.invalidate_cache()


def test_no_table_keeps_todays_launch(table):
    assert tuned.tuned_path().endswith("tuned.json")
    assert tuned.tuned_launch("score_update", 32, 1024, 32) is None
    assert tuned.tuned_launch("vmem_gather", 1, 8) is None
    assert su.launch_threads() == su.DEFAULT_THREADS == 256
    assert vg.launch_blocks_per_sm(CPU) == vg.DEFAULT_BLOCKS_PER_SM == 2


def test_a_valid_entry_is_honored(table):
    table({"score_update": {"threads": 128},
           "vmem_gather": {"blocks_per_sm": 4}})
    assert tuned.tuned_launch("score_update", 32, 1024, 32) == 128
    assert su.launch_threads() == 128
    assert vg.launch_blocks_per_sm(CPU) == 4
    # the override keyword beats the table
    assert su.launch_threads(512) == 512
    assert vg.launch_blocks_per_sm(CPU, 1) == 1


@pytest.mark.parametrize("bad", [True, 128.0, -64, 2048, 48, 0, "128", None])
def test_unusable_thread_entries_fall_back(table, bad):
    # bool, float, negative, over the block limit, not whole warps, zero,
    # wrong type: ignored rather than producing an invalid launch
    table({"score_update": {"threads": bad}})
    assert tuned.tuned_launch("score_update", 32, 1024, 32) is None, bad
    assert su.launch_threads() == 256


@pytest.mark.parametrize("bad", [True, 2.0, -1, 0, 9, "2", None])
def test_unusable_block_entries_fall_back(table, bad):
    table({"vmem_gather": {"blocks_per_sm": bad}})
    assert tuned.tuned_launch("vmem_gather", 1, vg.MAX_BLOCKS_PER_SM) is None
    assert vg.launch_blocks_per_sm(CPU) == 2


@pytest.mark.parametrize("text", [
    json.dumps({"score_update": [128]}),
    json.dumps([{"score_update": {"threads": 128}}]),
    json.dumps({"score_update": {"block_rows": 16}}),
    "{not json",
])
def test_malformed_tables_drop_to_the_constants(table, text):
    # a list entry, a list table, the reference's row-block key (a table
    # the JAX harness wrote) and malformed JSON all leave today's launch
    table(text)
    assert tuned.tuned_launch("score_update", 32, 1024, 32) is None
    assert su.launch_threads() == 256


@pytest.mark.parametrize("bad", [0, 9, True, 2.5, "2"])
def test_a_bad_gather_override_raises_on_the_cpu(bad):
    t = torch.arange(40, dtype=torch.float32)
    src = torch.randint(-1, 40, (40, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="blocks_per_sm"):
        vg.vmem_gather(t, src, blocks_per_sm=bad)


@pytest.mark.parametrize("bad", [0, 16, 48, 2048, True, 256.0])
def test_a_bad_thread_override_raises_on_the_cpu(bad):
    p = SimParams(n=8, capacity=4)
    f = torch.ones((8, 4))
    with pytest.raises(ValueError, match="threads"):
        su.score_update(f, f, torch.tensor([0.5, 0.5]), p, threads=bad)


def test_a_valid_override_runs_the_plain_version_on_the_cpu(table):
    table({"score_update": {"threads": 64}})
    t = torch.arange(40, dtype=torch.float32)
    src = torch.randint(-1, 40, (40, 6), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    before = (vg.launches, su.launches)
    for b in range(1, vg.MAX_BLOCKS_PER_SM + 1):
        assert torch.equal(vg.vmem_gather(t, src, blocks_per_sm=b),
                           vg.vmem_gather_ref(t, src))
    p = SimParams(n=8, capacity=4, slow_weight=-10.0)
    f = torch.rand((8, 4), generator=torch.Generator().manual_seed(1))
    sc = torch.tensor([0.5, 0.25])
    want = su.score_update_ref(f, f, sc, p)
    for th in (32, 1024, None):
        got = su.score_update(f, f, sc, p, threads=th)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (vg.launches, su.launches) == before
