"""The port's SimParams/SimState/init_state against the reference: the same
leaf names, dtypes and bits, and a lossless numpy round trip."""

import dataclasses

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import state as tst

torch.set_num_threads(1)


def _jax_leaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def test_simparams_fields_match_the_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(jst.SimParams)]
    got = [(f.name, f.default) for f in dataclasses.fields(tst.SimParams)]
    assert got == want
    assert tst.leaf_names() == tuple(
        f.name for f in dataclasses.fields(jst.SimState))


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_init_state_bitwise(seed):
    want = _jax_leaves(jst.init_state(jst.SimParams(n=200, capacity=40),
                                      seed))
    got = interop.state_to_numpy(
        tst.init_state(tst.SimParams(n=200, capacity=40), seed, "cpu"))
    assert interop.leaf_mismatches(want, got) == []


def test_numpy_round_trip_is_lossless():
    st = tst.init_state(tst.SimParams(n=50, capacity=16), 9, "cpu")
    leaves = interop.state_to_numpy(st)
    back = interop.state_to_numpy(interop.state_from_numpy(leaves, "cpu"))
    assert interop.leaf_mismatches(leaves, back) == []
    assert st.t_ms.shape == () and st.key.dtype == torch.int64


def test_score_formula_matches_the_reference():
    rng = np.random.default_rng(0)
    fmd = rng.uniform(0, 40, size=(30, 8)).astype(np.float32)
    slow = rng.uniform(0, 3, size=(30, 8)).astype(np.float32)
    pj = jst.SimParams(n=30, capacity=8, slow_weight=-2.5)
    pt = tst.SimParams(n=30, capacity=8, slow_weight=-2.5)
    sj = jst.init_state(pj, 0)
    sj = sj.replace(fmd=sj.fmd + fmd, slow_penalty=sj.slow_penalty + slow)
    st = interop.state_from_numpy(_jax_leaves(sj), "cpu")
    assert np.array_equal(st.score(pt).numpy(), np.asarray(sj.score(pj)))


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(capsys):
    from dst_libp2p_test_node_tpu_torch import cli
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig, Simulator)

    params = tst.SimParams(n=20, capacity=16)
    if torch.cuda.is_available():
        assert tst.init_state(params, 0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.init_state(params, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(ExperimentConfig())
    with pytest.raises(SystemExit) as exc:
        cli.main(["run", "1", "50", "15000", "1", "1", "50", "150", "40",
                  "130", "5", "0.0", "4", "0", "1000",
                  "--delivery-mode", "bounded"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
