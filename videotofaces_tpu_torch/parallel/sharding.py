"""Parameter sharding rules for tensor parallelism (counterpart of
videotofaces_tpu/parallel/sharding.py).

Megatron-style ViT sharding: q/k/v and mlp.fc1 split their OUTPUT features
over ``"model"`` (column parallel), proj and mlp.fc2 split their INPUT
features (row parallel), so each block sums one partial product per
``"model"`` device (the all-reduce). Everything else (embeddings, norms,
heads) is replicated.

A spec is the JAX ``PartitionSpec`` as a plain tuple, one entry per
dimension of the leaf in the JAX layout (``[in, out]`` dense kernels):
``(None, "model")``, ``("model",)`` or ``()`` (replicated). The rules read
the JAX tree paths; the port's state-dict names map to them through
``utils/weights.py::jax_path``, so one rule serves both packages.
"""

import torch


def vit_param_spec(path_parts):
    """The spec of one ViT leaf, from its JAX tree path."""
    path = "/".join(path_parts)
    if "/attn/" in path and path.endswith("kernel"):
        return (None, "model")           # column parallel: [d, d] -> split heads
    if "/attn/" in path and path.endswith("bias"):
        return ("model",)
    if "mlp/fc1" in path and path.endswith("kernel"):
        return (None, "model")
    if "mlp/fc1" in path and path.endswith("bias"):
        return ("model",)
    if "mlp/fc2" in path and path.endswith("kernel"):
        return ("model", None)           # row parallel
    if path.endswith("proj/kernel"):
        return ("model", None)
    return ()


def fit_spec(spec, shape, mesh):
    """``spec`` for a leaf of ``shape`` on ``mesh``, or ``()`` where an axis
    does not divide its dimension (replication is always legal, a
    non-divisible shard is not), as the JAX package's
    ``param_sharding_tree`` falls back. An axis the mesh lacks has size 1."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            size *= mesh.shape.get(a, 1)
        if dim >= len(shape) or shape[dim] % size != 0:
            return ()
    return tuple(spec)


def model_dim(spec):
    """The dimension a spec splits over ``"model"``, or None."""
    for dim, axis in enumerate(spec):
        if axis == "model":
            return dim
        if axis is not None:
            raise ValueError("only the \"model\" axis shards parameters, not %r" % (axis,))
    return None


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn(list(path), tree)


def param_sharding_tree(params, mesh, rule=vit_param_spec):
    """A parameter tree (nested dicts of arrays or tensors, JAX layout) ->
    the same tree of specs: ``rule(path_parts)`` with ``fit_spec``'s
    fallback."""
    return _map_with_path(params, lambda path, leaf: fit_spec(rule(path), tuple(leaf.shape),
                                                              mesh))


def split_leaf(t, dim, mesh):
    """``t`` placed on ``mesh``: ``[row][j]`` is block ``j`` of ``t`` along
    ``dim`` (the whole of ``t`` when ``dim`` is None) on device
    ``mesh.grid[row][j]``; one copy per distinct (device, block), shared by
    the places that name it."""
    n = len(mesh.grid[0])
    blocks = [t] * n if dim is None else list(t.tensor_split(n, dim))
    placed = {}

    def at(d, j):
        key = (d, None if dim is None else j)
        if key not in placed:
            placed[key] = blocks[j].contiguous().to(d, copy=True)
        return placed[key]

    return tuple(tuple(at(d, j) for j, d in enumerate(row)) for row in mesh.grid)


def shard_params(params, mesh, rule=vit_param_spec):
    """Place a parameter tree (JAX layout; numpy arrays or tensors) on
    ``mesh`` by ``param_sharding_tree``: each leaf becomes ``split_leaf``'s
    ``[row][j]`` grid of tensors."""
    specs = param_sharding_tree(params, mesh, rule)

    def place(path, leaf):
        spec = specs
        for p in path:
            spec = spec[p]
        return split_leaf(torch.as_tensor(leaf), model_dim(spec), mesh)

    return _map_with_path(params, place)
