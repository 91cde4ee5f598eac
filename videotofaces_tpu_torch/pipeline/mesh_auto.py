"""Default device-mesh policy of the user-facing pipeline (counterpart of
videotofaces_tpu/pipeline/mesh_auto.py).

The reference picks one global torch device (main.py:38-39). Every wrapper,
both model factories and ``FaceService`` take ``mesh=`` and shard their
batches data-parallel over it (parallel/mesh.py); ``dedup_cosine``,
``kmeans_fit`` and ``silhouette_score`` take it too.

``default_mesh()`` is the JAX package's rule: a mesh over every card of the
host, or None with fewer than two cards or under V2F_SINGLE_DEVICE=1. Pass
it (``mesh=default_mesh()``) to shard over all of them.

``mesh="auto"``, the default of the factories and ``FaceService`` as in the
JAX package, keeps one card here, where the JAX package takes
``default_mesh()``: on two H100s every sharded call measured slower than
the same call on one card (PERF.md, section 5), so the port holds that
default back until a sharded design beats one card.
"""

import os


def default_mesh():
    """A 1-axis ``"data"`` mesh over every CUDA device of the host, or None
    with fewer than two (or none), or when the user opted out."""
    if os.environ.get("V2F_SINGLE_DEVICE", "") not in ("", "0"):
        return None
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh()


def resolve_mesh(mesh):
    """What ``mesh=`` stands for: ``"auto"`` is None (one device; see the
    module docstring), a ``Mesh`` or None is returned as it is."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError("mesh must be a Mesh, None or \"auto\", not %r" % mesh)
        return None
    return mesh
