"""The plain versions of the port's two kernels against the reference's
Pallas kernels run in interpret mode (and against score_update_xla), plus
the wrappers' CPU dispatch. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.native import score_update as jsu
from dst_libp2p_test_node_tpu.native import vmem_gather as jvg
from dst_libp2p_test_node_tpu.ops.state import SimParams as JParams
from dst_libp2p_test_node_tpu_torch.native import build, gather_bench
from dst_libp2p_test_node_tpu_torch.native import score_update as tsu
from dst_libp2p_test_node_tpu_torch.native import vmem_gather as tvg
from dst_libp2p_test_node_tpu_torch.ops.state import SimParams as TParams

torch.set_num_threads(1)


def _gather_inputs(n, c, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 5000, size=n).astype(np.float32)
    t[rng.random(n) < 0.15] = np.float32(3.4e38)
    src = rng.integers(0, n, size=(n, c)).astype(np.int32)
    src[rng.random((n, c)) < 0.1] = -1
    return t, src


@pytest.mark.parametrize("shape", [(64, 8), (48, 40), (30, 7), (31, 37),
                                   (1, 1)])
def test_vmem_gather_ref_matches_pallas_interpret(shape):
    n, c = shape
    t, src = _gather_inputs(n, c, seed=n)
    want = np.asarray(jvg.vmem_gather(jnp.asarray(t), jnp.asarray(src),
                                      interpret=True))
    got = tvg.vmem_gather(torch.from_numpy(t), torch.from_numpy(src))
    assert got.numpy().tobytes() == want.tobytes()


def test_vmem_gather_batched_forms_on_cpu():
    t, src = _gather_inputs(40, 6, seed=1)
    tb = np.stack([t, t[::-1].copy(), t + np.float32(1.0)])
    srcb = np.stack([src, src[::-1].copy(), (src + 1) % 40])
    got = tvg.vmem_gather(torch.from_numpy(tb), torch.from_numpy(srcb))
    for i in range(3):
        want = np.asarray(jvg.vmem_gather(
            jnp.asarray(tb[i]), jnp.asarray(srcb[i]), interpret=True))
        assert got[i].numpy().tobytes() == want.tobytes()
    shared = tvg.vmem_gather(torch.from_numpy(t), torch.from_numpy(srcb))
    assert torch.equal(shared[1], tvg.vmem_gather_ref(
        torch.from_numpy(t), torch.from_numpy(srcb[1])))


@pytest.mark.parametrize("batch,n,c", [(3, 31, 7), (2, 5, 3)])
@pytest.mark.parametrize("t_rows", ["per_row", "shared"])
def test_vmem_gather_batched_ragged_matches_pallas(batch, n, c, t_rows):
    # rows of n * c elements, not a multiple of 4: on the card every batch
    # row after the first starts in the middle of a 16-byte vector
    rng = np.random.default_rng(n * c)
    t, _ = _gather_inputs(n, 1, seed=n)
    srcb = rng.integers(-1, n, size=(batch, n, c)).astype(np.int32)
    tb = (np.stack([t + np.float32(i) for i in range(batch)])
          if t_rows == "per_row" else t)
    got = tvg.vmem_gather(torch.from_numpy(tb), torch.from_numpy(srcb))
    assert got.shape == (batch, n, c)
    for i in range(batch):
        t_i = tb[i] if t_rows == "per_row" else tb
        want = np.asarray(jvg.vmem_gather(
            jnp.asarray(t_i), jnp.asarray(srcb[i]), interpret=True))
        assert got[i].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", [(31, 37), (1, 1), (0, 40), (3, 31, 7)])
def test_vmem_gather_on_cpu_never_builds_or_launches(shape, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    n = max(shape[-2], 1)
    t = torch.arange(n, dtype=torch.float32)
    src = torch.randint(-1, n, shape, dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    before = tvg.launches
    got = tvg.vmem_gather(t, src)
    assert tvg.launches == before
    assert torch.equal(got, tvg.vmem_gather_ref(t, src))


def test_vmem_gather_rejects_what_the_kernel_does_not_take():
    t = torch.arange(40, dtype=torch.float32)
    src = torch.randint(0, 40, (40, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        tvg.vmem_gather(t, src.t())
    with pytest.raises(ValueError, match="contiguous"):
        tvg.vmem_gather(t[::2], src)
    with pytest.raises(ValueError, match="non-empty"):
        tvg.vmem_gather(t[:0], src)
    with pytest.raises(ValueError, match="same batch"):
        tvg.vmem_gather(t.reshape(2, 20), src.reshape(4, 10, 6))


def test_wrappers_use_the_plain_version_on_cpu_and_count_no_launch():
    t, src = _gather_inputs(32, 5, seed=2)
    before = (tvg.launches, tsu.launches)
    tvg.vmem_gather(torch.from_numpy(t), torch.from_numpy(src))
    p = TParams(n=32, capacity=5)
    f = torch.ones((32, 5))
    tsu.score_update(f, f, torch.tensor([0.5, 0.5]), p)
    assert (tvg.launches, tsu.launches) == before
    with pytest.raises(TypeError):
        tvg.vmem_gather(torch.from_numpy(t).double(), torch.from_numpy(src))
    with pytest.raises(ValueError):
        tsu.score_update(f, f, torch.tensor([0.5, 0.5, 0.5]), p)


@pytest.mark.parametrize("shape,scales", [((64, 5), (0.9, 0.8)),
                                          ((30, 7), (0.9 ** 13, 0.2 ** 4)),
                                          ((256, 40), (1.0, 1.0))])
def test_score_update_ref_matches_pallas_and_xla(shape, scales):
    n, c = shape
    rng = np.random.default_rng(n)
    # span the flush-to-zero cutoff so both where() branches are live
    fmd = rng.uniform(0.0, 40.0, size=(n, c)).astype(np.float32)
    slow = rng.uniform(0.0, 0.5, size=(n, c)).astype(np.float32)
    pj = JParams(n=n, capacity=c, slow_weight=-10.0)
    pt = TParams(n=n, capacity=c, slow_weight=-10.0)
    f_sc, s_sc = (np.float32(s) for s in scales)
    got = tsu.score_update(torch.from_numpy(fmd), torch.from_numpy(slow),
                           torch.tensor([f_sc, s_sc]), pt)
    for want in (jsu.score_update(jnp.asarray(fmd), jnp.asarray(slow),
                                  f_sc, s_sc, pj, interpret=True),
                 jsu.score_update_xla(jnp.asarray(fmd), jnp.asarray(slow),
                                      f_sc, s_sc, pj)):
        # the carried counters bitwise; the score within the reference
        # probe's tolerance (native/score_update.py _probe)
        assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
        assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-6)


def test_kernel_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    assert set(build.KERNELS) == {"vmem_gather", "score_update"}
    for name, src in build.KERNELS.items():
        with open(f"{build.CSRC_DIR}/{src}") as f:
            (tmp_path / src).write_text(f.read())
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = {n: build.library_path(n) for n in build.KERNELS}
    for name, path in before.items():
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
        assert path == build.library_path(name)
    # an edited source gets a new library; the other kernel keeps its own
    with open(tmp_path / "vmem_gather.cu", "a") as f:
        f.write("// edited\n")
    assert build.library_path("vmem_gather") != before["vmem_gather"]
    assert build.library_path("score_update") == before["score_update"]


def test_each_kernel_is_one_self_contained_source():
    # library_path hashes the kernel's .cu alone, so no kernel may include
    # a header of its own (an edit to it would not rebuild the library)
    assert sorted(os.listdir(build.CSRC_DIR)) == sorted(build.KERNELS.values())
    for src in build.KERNELS.values():
        with open(os.path.join(build.CSRC_DIR, src)) as f:
            includes = re.findall(r"^\s*#\s*include\s*(\S+)", f.read(), re.M)
        assert includes and all(i.startswith("<") for i in includes), includes


def test_gather_bench_variants_are_edits_of_the_kept_source():
    with open(os.path.join(build.CSRC_DIR, "vmem_gather.cu")) as f:
        kept = f.read()
    for name, edits in gather_bench.VARIANTS.items():
        text = gather_bench.edited(kept, edits)
        assert (text == kept) == (name == "kept"), name
    with pytest.raises(ValueError, match="anchor"):
        gather_bench.edited(kept, [("no such line", "")])
