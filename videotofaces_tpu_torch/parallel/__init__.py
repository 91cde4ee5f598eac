"""Data parallelism over the devices of one host (counterpart of
videotofaces_tpu/parallel/, its ``"data"`` axis)."""

from .mesh import (Mesh, gather_rows, make_mesh, map_shards, pad_to_multiple,  # noqa: F401
                   row_ranges, split_rows)
from ..pipeline.mesh_auto import default_mesh  # noqa: F401
