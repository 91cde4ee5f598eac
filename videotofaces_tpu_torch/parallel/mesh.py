"""Device mesh and sharded calls (counterpart of
videotofaces_tpu/parallel/mesh.py, the ``"data"`` axis only).

The JAX package jits a graph over a ``jax.sharding.Mesh`` and XLA
partitions it. PyTorch runs eagerly, so here a mesh is an ordered tuple of
devices on one ``"data"`` axis, and a sharded call splits its rows into one
contiguous block per device (``split_rows``), runs the blocks one after
another in the calling thread, each under its device (``map_shards``), and
joins the results in block order (``gather_rows``). What the JAX package's
``batch_sharding`` does to the batch axis, ``split_rows`` does; what
``replicated`` does to the parameters, the wrappers do by keeping one copy
of a module on each distinct device of the mesh.

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
    """The mesh's devices in shard order; ``.size`` as the JAX call sites
    read it off ``mesh.devices``."""

    @property
    def size(self):
        return len(self)


class Mesh:
    """An ordered tuple of ``torch.device``s on one ``"data"`` axis.
    ``mesh.shape["data"]`` is the number of shards, ``mesh.devices`` the
    device of each shard (with ``.size``), ``mesh.distinct`` each device
    once, in order of first appearance."""

    def __init__(self, devices):
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
        self.devices = _Devices(devs)
        self.shape = {"data": len(devs)}
        self.distinct = tuple(dict.fromkeys(devs))

    def __repr__(self):
        return "Mesh(data=%d: %s)" % (len(self.devices),
                                      ", ".join(str(d) for d in self.devices))


def make_mesh(n_data=None, n_model=1, devices=None):
    """A 1-axis ``"data"`` mesh over the first ``n_data`` of ``devices``
    (default: every CUDA device of the host, ``cuda:0`` .. ``cuda:{n-1}``;
    raises when there is none). ``devices`` may repeat a device (see the
    module docstring). ``n_model > 1``, tensor parallelism, is not ported
    (ROADMAP.md, item 11c) and raises."""
    if n_model != 1:
        raise NotImplementedError(
            "tensor parallelism (n_model > 1) is not ported; see ROADMAP.md, item 11c")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(for example [\"cpu\"] * 2)")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError("n_data=%d, but %d device(s) were given" % (n_data, len(devices)))
    return Mesh(devices[:n_data])


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
    """``[fn(d_k, *(p[k] for p in parts)) for each shard k]``: the shards
    one after another in the calling thread, each under
    ``torch.cuda.device(d_k)``, so that every launch of shard k is queued
    on its device's current stream. ``mesh`` None runs the one shard on
    ``device``. A shard that raises makes the call raise: no shard is
    dropped or retried on another device.

    The shards run in the calling thread because the detectors' forwards
    are bound by their host launches and syncs: worker threads, one per
    shard, measured slower than this loop on one card and on two (PERF.md,
    section 6)."""
    devices = (device,) if mesh is None else mesh.devices
    out = []
    for k, d in enumerate(devices):
        with _device_guard(d):
            out.append(fn(d, *(p[k] for p in parts)))
    return out
