"""Parallelism over the devices of one host (counterpart of
videotofaces_tpu/parallel/): the ``("data", "model")`` mesh, the sharded
calls and the tensor-parallel sharding rules."""

from .mesh import (Mesh, gather_rows, make_mesh, map_shards, pad_to_multiple,  # noqa: F401
                   row_ranges, split_rows)
from .sharding import vit_param_spec, shard_params  # noqa: F401
from ..pipeline.mesh_auto import default_mesh  # noqa: F401
