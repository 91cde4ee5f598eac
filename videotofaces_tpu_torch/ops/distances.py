"""Pairwise-distance Gram matrices on the device (counterpart of
videotofaces_tpu/ops/distances.py).

Replaces sklearn.metrics.pairwise_distances / cosine_distances used by the
dedup and classification stages (dupes.py:56-60, grouping.py:51). Hamming
distance over {0,1} hash vectors and cosine distance both reduce to
matmuls, which follow the precision policy of ``config`` (TF32 off in
"highest"). Inputs are torch tensors; results stay on their device.
"""

import torch

from ..parallel.mesh import gather_rows, map_shards, row_ranges


def hamming_gram(x, y=None):
    """Pairwise Hamming distances between {0,1} int vectors: [N, M] int32.

    d(a, b) = a @ (1-b) + (1-a) @ b — exact in float32 for <= 2^24 bits.
    """
    xf = x.to(torch.float32)
    yf = xf if y is None else y.to(torch.float32)
    d = xf @ (1.0 - yf).T + (1.0 - xf) @ yf.T
    return torch.round(d).to(torch.int32)


def cosine_gram(x, y=None):
    """Pairwise cosine distances (1 - cos similarity), sklearn-compatible:
    rows are L2-normalized with zero-norm rows left as zeros."""

    def normalize(a):
        n = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
        return a / torch.where(n == 0, torch.ones_like(n), n)

    xn = normalize(x.to(torch.float32))
    yn = xn if y is None else normalize(y.to(torch.float32))
    return 1.0 - xn @ yn.T


def nearest_earlier(dist, big=10000.0, row0=0):
    """For each row i: (min, argmin) of dist[i, :i] — the distance to the
    nearest EARLIER element, with row 0 getting >= ``big``. ``argmin``
    returns the first minimum, as ``jnp.argmin`` does (dupes.py:62-64).
    ``dist`` may be a block of rows [rows, N] of the full [N, N] matrix,
    starting at row ``row0``."""
    rows = torch.arange(row0, row0 + dist.shape[0], device=dist.device)
    cols = torch.arange(dist.shape[1], device=dist.device)
    later = (cols[None, :] >= rows[:, None]).to(dist.dtype)
    masked = dist + later * big
    return masked.min(dim=1).values, torch.argmin(masked, dim=1)


def dedup_hash(hashes_u8):
    """All-pairs hash dedup reductions: hashes [N, 64] {0,1} ->
    (mins [N] int32, argmins [N] int32)."""
    mins, inds = nearest_earlier(hamming_gram(hashes_u8).to(torch.float32))
    return mins.to(torch.int32), inds.to(torch.int32)


def dedup_cosine(feats, mesh=None):
    """All-pairs embedding dedup reductions: feats [N, D] (a tensor) ->
    (mins, argmins), on feats' device. With ``mesh`` (parallel/mesh.py) the
    N^2 Gram shards on rows: each shard's device takes a contiguous block of
    rows against all of them, and the (min, argmin) pairs come back in row
    order on the mesh's first device."""
    if mesh is None:
        return nearest_earlier(cosine_gram(feats))

    def shard(dev, rows):
        full = feats.to(dev)
        return nearest_earlier(cosine_gram(full[rows[0]:rows[1]], full), row0=rows[0])

    parts = map_shards(mesh, shard, row_ranges(feats.shape[0], mesh))
    dev0 = mesh.shards[0]
    return (gather_rows([m for m, _ in parts], dev0),
            gather_rows([i for _, i in parts], dev0))
