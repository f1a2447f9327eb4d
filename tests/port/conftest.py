"""The peer-mesh tests' shared rank processes, spawned on first use and
shared by the files of one test process, so their ranks start once:

  cpu_mesh   a peer mesh of two gloo CPU ranks (tests/port/
             test_torch_peer_*.py, the campaign and the recorder on a
             mesh)
  cpu_grid   a 2 x 2 trial grid: four gloo CPU ranks in two trial groups
             of two (tests/port/test_torch_nested_windows.py, the nested
             campaign)"""

import pytest

from dst_libp2p_test_node_tpu_torch.parallel.ranks import RankPool
from dst_libp2p_test_node_tpu_torch.parallel.sharding import make_peer_mesh


@pytest.fixture(scope="session")
def cpu_mesh():
    with make_peer_mesh(devices=["cpu"] * 2, threads=1) as m:
        yield m


@pytest.fixture(scope="session")
def cpu_grid():
    with RankPool(["cpu"] * 4, threads=1, peer_width=2) as pool:
        yield pool
