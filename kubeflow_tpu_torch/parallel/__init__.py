"""Parallelism of the PyTorch port (counterpart of
``kubeflow_tpu.parallel``): the tensor-parallel mesh and the
logical-axis sharding rules; ``parallel.depot`` holds the executable
depot's env contract. Other axes are a later slice."""

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_ORDER, TensorMesh, mesh_from_topology_env, parse_topology_env,
)
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, pspec, shard_tree, validate_divisibility,
)

__all__ = ["AXIS_ORDER", "DEFAULT_RULES", "TensorMesh",
           "mesh_from_topology_env", "parse_topology_env", "pspec",
           "shard_tree", "validate_divisibility"]
