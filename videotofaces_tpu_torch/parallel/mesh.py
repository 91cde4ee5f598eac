"""Device mesh and sharded calls (counterpart of
videotofaces_tpu/parallel/mesh.py).

The JAX package jits a graph over a ``jax.sharding.Mesh`` and XLA
partitions it. PyTorch runs eagerly, so here a mesh is a grid of devices,
``(n_data, n_model)`` in the JAX package's order (the first ``n_data *
n_model`` devices, row-major), driven from the calling thread. Row ``i``
is data shard ``i``; its first device (``mesh.shards[i]``) runs what the
JAX package shards over ``"data"`` and replicates over ``"model"``. A
sharded call splits its rows into one contiguous block per data shard
(``split_rows``), runs the blocks one after another in the calling
thread, each under its shard's device (``map_shards``), and joins the
results in block order (``gather_rows``). What the JAX package's
``batch_sharding`` does to the batch axis, ``split_rows`` does; what
``replicated`` does to the parameters, the wrappers do by keeping one copy
of a module on each distinct shard device. The ``"model"`` axis is read
only by the tensor-parallel training step (train/trainer.py), which
splits the ViT blocks' weights over a row's devices (parallel/sharding.py).

A mesh may name one device more than once: ``make_mesh(devices=["cpu"] *
2)`` or ``[cuda:0, cuda:0]`` runs two shards on one device, which share its
module and its stream. That is the counterpart of XLA's forced host device
count, with which the JAX package's tests shard over 8 virtual CPU devices:
it runs the sharded path, held to the single-device call, on a host with
one card or none.
"""

import contextlib

import numpy as np
import torch

from .. import config


class _Devices(tuple):
    """The mesh's devices, row-major over ``shape`` (``(n_data,)`` or
    ``(n_data, n_model)``); ``.size`` the total count, as the JAX call
    sites read them off ``mesh.devices``."""

    def __new__(cls, devices, shape):
        out = super().__new__(cls, devices)
        out.shape = shape
        return out

    def __getnewargs__(self):
        return tuple(self), self.shape

    @property
    def size(self):
        return len(self)


class Mesh:
    """A grid of ``torch.device``s, ``n_data`` rows of ``n_model``.
    ``mesh.shape`` is ``{"data": n_data}``, and ``{"data": n_data,
    "model": n_model}`` when ``n_model > 1``; ``mesh.devices`` every device
    row-major (with ``.size`` and ``.shape``); ``mesh.grid`` the rows;
    ``mesh.shards`` the first device of each row, where data shard ``i``
    runs; ``mesh.distinct`` each shard device once, in order of first
    appearance."""

    def __init__(self, devices, n_model=1):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type not in ("cpu", "cuda"):
                raise ValueError("a mesh holds cpu or cuda devices, not %s" % d)
            if d.type == "cuda":
                d = config.resolve_device(d)
                if d.index >= torch.cuda.device_count():
                    raise ValueError("%s: this host has %d CUDA device(s)"
                                     % (d, torch.cuda.device_count()))
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if n_model < 1 or len(devs) % n_model:
            raise ValueError("%d device(s) do not make rows of n_model=%d"
                             % (len(devs), n_model))
        n_data = len(devs) // n_model
        self.grid = tuple(tuple(devs[i * n_model:(i + 1) * n_model]) for i in range(n_data))
        self.shape = {"data": n_data} if n_model == 1 else {"data": n_data, "model": n_model}
        self.axis_names = tuple(self.shape)
        self.devices = _Devices(devs, tuple(self.shape.values()))
        self.shards = tuple(row[0] for row in self.grid)
        self.distinct = tuple(dict.fromkeys(self.shards))

    def __repr__(self):
        return "Mesh(%s: %s)" % (", ".join("%s=%d" % kv for kv in self.shape.items()),
                                 " | ".join(", ".join(str(d) for d in row)
                                            for row in self.grid))


def make_mesh(n_data=None, n_model=1, devices=None):
    """A ``("data",)`` mesh, or a ``("data", "model")`` one when ``n_model
    > 1``, over the first ``n_data * n_model`` of ``devices`` in rows of
    ``n_model`` (default: every CUDA device of the host, ``cuda:0`` ..
    ``cuda:{n-1}``; raises when there is none). ``n_data`` None: as many
    rows as the devices fill. ``devices`` may repeat a device (see the
    module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(for example [\"cpu\"] * 2)")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_model < 1:
        raise ValueError("n_model=%d" % n_model)
    if n_data is None:
        n_data = len(devices) // n_model
    if not 1 <= n_data * n_model <= len(devices):
        raise ValueError("n_data=%d x n_model=%d, but %d device(s) were given"
                         % (n_data, n_model, len(devices)))
    return Mesh(devices[:n_data * n_model], n_model)


def pad_to_multiple(n, k):
    return -(-n // k) * k


def row_ranges(n, mesh):
    """The [start, stop) rows of each shard's block of ``n`` rows: one
    contiguous block per shard of ``mesh`` (one when ``mesh`` is None), in
    shard order, the first ``n % shards`` blocks one row longer."""
    k = 1 if mesh is None else mesh.shape["data"]
    bounds = [i * (n // k) + min(i, n % k) for i in range(k + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def split_rows(x, mesh):
    """``x`` (a tensor, numpy array or list) cut on its first axis into the
    blocks of ``row_ranges``: views, in shard order."""
    return [x[a:b] for a, b in row_ranges(len(x), mesh)]


def gather_rows(parts, device=None):
    """The blocks of ``split_rows`` joined in shard order: numpy arrays on
    the host, tensors on ``device`` (default: the first block's). One block
    is returned as it is."""
    if len(parts) == 1 and device is None:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        device = parts[0].device if device is None else device
        return torch.cat([p.to(device) for p in parts])
    return np.concatenate(parts)


def _device_guard(device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def map_shards(mesh, fn, *parts, device=None):
    """``[fn(d_k, *(p[k] for p in parts)) for each shard k]``: the data
    shards one after another in the calling thread, each under
    ``torch.cuda.device(d_k)`` (``d_k = mesh.shards[k]``), so that every
    launch of shard k is queued on its device's current stream. ``mesh``
    None runs the one shard on ``device``. A shard that raises makes the call raise: no shard is
    dropped or retried on another device.

    The shards run in the calling thread because the detectors' forwards
    are bound by their host launches and syncs: worker threads, one per
    shard, measured slower than this loop on one card and on two (PERF.md,
    section 6)."""
    devices = (device,) if mesh is None else mesh.shards
    out = []
    for k, d in enumerate(devices):
        with _device_guard(d):
            out.append(fn(d, *(p[k] for p in parts)))
    return out
