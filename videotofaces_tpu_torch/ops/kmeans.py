"""K-means with sklearn-parity k-means++ initialization (counterpart of
videotofaces_tpu/ops/kmeans.py).

Replaces ``sklearn.cluster.KMeans(n_clusters=k, random_state=r, n_init='auto')``
(reference grouping.py:99-101). Design:

- k-means++ seeding runs on the HOST in numpy, drawing from
  ``np.random.RandomState`` in exactly the published order, so seeds match
  sklearn (and the JAX package) for the same ``random_state``;
- Lloyd iterations run on the DEVICE: the assignment step is an [N, K]
  squared-distance matrix in the ``x2 - 2xc + c2`` form (one matmul, in
  float64: see ``_sq_dists``), the update step a one-hot [K, N] @ [N, D]
  matmul; ``torch.argmin`` returns the first minimum, as ``jnp.argmin``
  does. Empty clusters are re-seeded on the host from the farthest points
  (sklearn's relocation rule);
- convergence mirrors sklearn: strict stop when labels repeat, else stop
  when the summed squared center shift <= tol * mean(var(X, axis=0)).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..parallel.mesh import map_shards, split_rows


def _sq_dists(x, centers):
    """[N, K] float64 squared euclidean distances (x2 - 2xc + c2, clipped at
    0). In float32 the form's cancellation errs by ~1e-5 at |x|^2 ~ 8, more
    than the margin between two near-tied centers: the labels then flip
    from one Lloyd step to the next where an exact Lloyd converges."""
    x, centers = x.double(), centers.double()
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    return torch.clamp(x2 - 2.0 * (x @ centers.T) + c2, min=0.0)


def kmeans_plusplus(x, n_clusters, random_state, n_local_trials=None):
    """Host k-means++ seeding with sklearn RNG parity. x: [N, D] float array.
    Returns (centers [K, D], indices [K])."""
    rs = np.random.RandomState(random_state) if not isinstance(
        random_state, np.random.RandomState) else random_state
    x = np.asarray(x)
    n = x.shape[0]
    if n_local_trials is None:
        n_local_trials = 2 + int(np.log(n_clusters))
    x_sq = np.einsum("ij,ij->i", x, x)

    def sq_dist_rows(rows):
        return np.maximum(
            x_sq[rows][:, None] - 2 * rows_dot(rows) + x_sq[None, :], 0)

    def rows_dot(rows):
        return x[rows] @ x.T

    indices = np.full(n_clusters, -1, dtype=int)
    first = rs.choice(n, p=np.full(n, 1.0 / n))
    indices[0] = first
    closest = sq_dist_rows(np.asarray([first]))[0]
    current_pot = closest.sum()

    for c in range(1, n_clusters):
        rand_vals = rs.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(closest), rand_vals)
        np.clip(candidate_ids, None, n - 1, out=candidate_ids)
        dists = sq_dist_rows(candidate_ids)
        np.minimum(closest, dists, out=dists)
        pots = dists.sum(axis=1)
        best = int(np.argmin(pots))
        current_pot = pots[best]
        closest = dists[best]
        indices[c] = candidate_ids[best]

    return x[indices].copy(), indices


def _partial_step(x, centers):
    """The assignment step over a block of rows, and the block's share of
    the update: labels, distances-to-closest, cluster sizes and the
    one-hot sums of the rows."""
    d = _sq_dists(x, centers)
    labels = torch.argmin(d, dim=1)
    closest = d.min(dim=1).values.to(x.dtype)
    onehot = F.one_hot(labels, centers.shape[0]).to(x.dtype)     # [N, K]
    return labels, closest, onehot.sum(dim=0), onehot.T @ x


class _Rows:
    """The points on the devices of the Lloyd steps: one block of rows per
    shard of ``mesh``, or all of them on ``device``."""

    def __init__(self, x, device, mesh):
        if mesh is not None and device is not None:
            raise ValueError("pass device= or mesh=, not both")
        self.mesh = mesh
        self.devices = mesh.shards if mesh is not None else (config.resolve_device(device),)
        self.dev0 = self.devices[0]
        self.blocks = [torch.from_numpy(np.ascontiguousarray(b)).to(d)
                       for b, d in zip(split_rows(x, mesh), self.devices)]

    def map(self, fn, centers):
        """``fn(block, centers)`` on every block, each on its device."""
        return map_shards(self.mesh, lambda dev, xb: fn(xb, centers.to(dev)), self.blocks,
                          device=self.dev0)

    def step(self, centers):
        """One Lloyd iteration: labels [N] (on the host), new centers and
        cluster sizes (reduced on the first device), and each block's
        distances-to-closest (on its device)."""
        parts = self.map(_partial_step, centers)
        counts, sums = parts[0][2], parts[0][3]
        for p in parts[1:]:
            counts = counts + p[2].to(self.dev0)
            sums = sums + p[3].to(self.dev0)
        new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
        # keep the old center where a cluster went empty (relocated on the host)
        new_centers = torch.where((counts == 0)[:, None], centers, new_centers)
        return _host_rows([p[0] for p in parts]), new_centers, counts, [p[1] for p in parts]


def _host_rows(blocks):
    """Per-block device tensors joined in row order on the host."""
    return np.concatenate([b.cpu().numpy() for b in blocks])


def _assign(x, centers):
    d = _sq_dists(x, centers)
    return torch.argmin(d, dim=1), d.min(dim=1).values.sum()


def kmeans_fit(x, n_clusters, random_state=0, max_iter=300, tol=1e-4, mesh=None, *,
               device=None):
    """Full K-means fit on ``device`` (None: the card). Returns (labels [N],
    centers [K, D], inertia). With ``mesh`` (parallel/mesh.py) the Lloyd
    steps run data-parallel: each shard assigns its block of rows and
    returns its one-hot sums and counts, which are added on the mesh's
    first device; the k-means++ seeding stays on the host."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    if n_clusters >= n:
        # degenerate sweep point (fewer samples than clusters): every point
        # its own cluster, higher cluster ids empty. sklearn raises here;
        # returning gracefully keeps a clusters-range sweep alive, but the
        # centers contract ([K, D]) is honored — empty clusters get zeros.
        labels = np.arange(n) % n_clusters
        centers = np.zeros((n_clusters, x.shape[1]), x.dtype)
        centers[:n] = x
        return labels, centers, 0.0
    rows = _Rows(x, device, mesh)
    centers = torch.from_numpy(kmeans_plusplus(x, n_clusters, random_state)[0]).to(rows.dev0)
    tol_abs = tol * float(np.mean(np.var(x, axis=0)))

    labels_prev = None
    strict = False
    labels = None
    for _ in range(max_iter):
        labels, new_centers, counts, closest = rows.step(centers)
        counts = counts.cpu().numpy()
        if (counts == 0).any():  # sklearn: reseed empties from farthest points
            new_centers = new_centers.cpu().numpy().copy()
            far = np.argsort(-_host_rows(closest))
            for slot, cid in enumerate(np.nonzero(counts == 0)[0]):
                new_centers[cid] = x[far[slot]]
            new_centers = torch.from_numpy(new_centers).to(rows.dev0)
        shift = float(torch.sum((new_centers - centers) ** 2))
        centers = new_centers
        if labels_prev is not None and np.array_equal(labels, labels_prev):
            strict = True
            break
        labels_prev = labels
        if shift <= tol_abs:
            break

    if not strict:  # final e-step against the final centers
        parts = rows.map(_assign, centers)
        labels = _host_rows([p[0] for p in parts])
        inertia = sum(float(p[1]) for p in parts)
    else:
        inertia = sum(float(c.sum()) for c in rows.step(centers)[3])
    return labels, centers.cpu().numpy(), inertia
