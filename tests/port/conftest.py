"""The peer-mesh tests' one mesh (tests/port/test_torch_peer_*.py): two
gloo CPU ranks per test process, spawned on first use and shared by the
files, so their ranks start once."""

import pytest

from dst_libp2p_test_node_tpu_torch.parallel.sharding import make_peer_mesh


@pytest.fixture(scope="session")
def cpu_mesh():
    with make_peer_mesh(devices=["cpu"] * 2, threads=1) as m:
        yield m
