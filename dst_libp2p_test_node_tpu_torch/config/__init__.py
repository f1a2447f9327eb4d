from .env import (
    NodeConfig,
    GossipSubParams,
    env_bool,
    env_int,
    env_float,
    get_peer_details,
    gossipsub_params_from_env,
)
from .topology import Topology, TopoParams

__all__ = [
    "NodeConfig",
    "GossipSubParams",
    "env_bool",
    "env_int",
    "env_float",
    "get_peer_details",
    "gossipsub_params_from_env",
    "Topology",
    "TopoParams",
]
