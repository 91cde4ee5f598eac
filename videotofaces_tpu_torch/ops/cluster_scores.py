"""Clustering quality scores as device reductions + rand index on the host
(counterpart of videotofaces_tpu/ops/cluster_scores.py).

Replaces sklearn.metrics.{silhouette_score, calinski_harabasz_score,
davies_bouldin_score, rand_score} used for K selection and the grouping eval
harness (reference grouping.py:104-108, 151-152). The three geometric scores
reduce to distance matrices and centroid statistics — matmuls and
reductions on the device (None: the card); inputs are numpy arrays.
Tight clusters need float64: the distances' ``x2 - 2xy + y2`` form
cancels, and in float32 its error (~1e-5 at |x|^2 ~ 8), like the float32
rounding of the centroids, moves the scores of points ~1e-5 apart by
whole percent. The silhouette computes its [rows, N] distance blocks in
float64 and reduces them in float32; the Calinski-Harabasz and
Davies-Bouldin scores, O(N D) work, run in float64 throughout.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..parallel.mesh import map_shards, row_ranges

_SIL_ROWS = 4096   # rows of the [rows, N] float64 silhouette distance block at a time


def _euclidean(a, b):
    """[len(a), len(b)] euclidean distances, the expansion computed in
    float64 (see the module docstring), returned in ``a``'s dtype."""
    a64, b64 = a.double(), b.double()
    d2 = (torch.sum(a64 * a64, dim=1)[:, None] - 2.0 * (a64 @ b64.T)
          + torch.sum(b64 * b64, dim=1)[None, :])
    return torch.sqrt(torch.clamp(d2, min=0.0)).to(a.dtype)


def _silhouette_sum(xr, labr, xf, onehot_f, counts, row0):
    """Silhouette sum over a block of rows. xr/labr: the block's rows, from
    row ``row0`` of the full set xf/onehot_f/counts. The [rows, N] distance
    block is the only O(N^2) object. A point's distance to itself is set
    to 0, as sklearn sets it: the expansion leaves the square root of a
    rounding residue there, which weighs against points ~1e-5 apart."""
    d = _euclidean(xr, xf)
    rows = torch.arange(xr.shape[0], device=xr.device)
    d[rows, rows + row0] = 0.0
    sums = d @ onehot_f                                          # [rows, K]
    own_count = counts[labr]
    own_sum = torch.gather(sums, 1, labr[:, None])[:, 0]
    a = own_sum / torch.clamp(own_count - 1.0, min=1.0)
    k = onehot_f.shape[1]
    inf = torch.full_like(sums, float("inf"))
    mean_other = sums / torch.clamp(counts, min=1.0)[None, :]
    mean_other = torch.where(F.one_hot(labr, k).bool(), inf, mean_other)
    mean_other = torch.where((counts == 0)[None, :], inf, mean_other)
    b = mean_other.min(dim=1).values
    sil = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
    sil = torch.where(own_count == 1, torch.zeros_like(sil), sil)
    return torch.sum(sil)


def _onehot_stats(labels, k, dtype=torch.float32):
    onehot = F.one_hot(labels, k).to(dtype)
    counts = onehot.sum(dim=0)
    return onehot, counts


def _inputs(x, labels, n_clusters, device, dtype=torch.float32):
    """The points on ``device`` (copied as float32, cast there to
    ``dtype``), the labels, and k."""
    device = config.resolve_device(device)
    labels = np.asarray(labels)
    k = int(n_clusters if n_clusters is not None else labels.max() + 1)
    xd = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device).to(dtype)
    return xd, torch.from_numpy(labels.astype(np.int64)).to(device), k


def silhouette_score(x, labels, n_clusters=None, mesh=None, *, device=None):
    """Mean silhouette coefficient, euclidean metric. Samples in singleton
    clusters score 0 (sklearn convention). With ``mesh`` (parallel/mesh.py)
    the [rows, N] distance blocks shard on rows: each shard's device sums
    the silhouettes of one contiguous block of rows."""
    if mesh is not None and device is not None:
        raise ValueError("pass device= or mesh=, not both")
    xd, lab, k = _inputs(x, labels, n_clusters,
                         mesh.shards[0] if mesh is not None else device)
    onehot, counts = _onehot_stats(lab, k)
    n = xd.shape[0]

    def shard(dev, rows):
        r0, r1 = rows
        xs, ls, oh, cs = (t.to(dev) for t in (xd, lab, onehot, counts))
        return sum(float(_silhouette_sum(xs[i:min(i + _SIL_ROWS, r1)],
                                         ls[i:min(i + _SIL_ROWS, r1)], xs, oh, cs, i))
                   for i in range(r0, r1, _SIL_ROWS))

    return sum(map_shards(mesh, shard, row_ranges(n, mesh), device=xd.device)) / n


def _centers(xd, onehot, counts):
    return (onehot.T @ xd) / torch.clamp(counts, min=1.0)[:, None]


def calinski_harabasz_score(x, labels, n_clusters=None, device=None):
    xd, lab, k = _inputs(x, labels, n_clusters, device, torch.float64)
    n = xd.shape[0]
    onehot, counts = _onehot_stats(lab, k, torch.float64)
    centers = _centers(xd, onehot, counts)
    mean = xd.mean(dim=0)
    between = torch.sum(counts * torch.sum((centers - mean) ** 2, dim=1))
    within = torch.sum((xd - centers[lab]) ** 2)
    if within == 0:
        return 1.0
    return float(between * (n - k) / (within * (k - 1)))


def davies_bouldin_score(x, labels, n_clusters=None, device=None):
    xd, lab, k = _inputs(x, labels, n_clusters, device, torch.float64)
    onehot, counts = _onehot_stats(lab, k, torch.float64)
    centers = _centers(xd, onehot, counts)
    # mean intra-cluster distance to the centroid
    dist_to_own = torch.sqrt(torch.clamp(torch.sum((xd - centers[lab]) ** 2, dim=1), min=0.0))
    s = (dist_to_own[None, :] @ onehot)[0] / torch.clamp(counts, min=1.0)
    m = _euclidean(centers, centers)
    r = (s[:, None] + s[None, :]) / torch.where(m == 0, torch.full_like(m, float("inf")), m)
    eye = torch.eye(k, dtype=torch.bool, device=xd.device)
    r = torch.where(eye, torch.full_like(r, float("-inf")), r)
    worst = r.max(dim=1).values
    worst = torch.where(torch.isinf(worst), torch.zeros_like(worst), worst)
    return float(worst.mean())


def rand_score(labels_true, labels_pred):
    """Rand index from the contingency table (host; inputs are tiny)."""
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = labels_true.size
    _, ti = np.unique(labels_true, return_inverse=True)
    _, pi = np.unique(labels_pred, return_inverse=True)
    cont = np.zeros((ti.max() + 1, pi.max() + 1), dtype=np.int64)
    np.add.at(cont, (ti, pi), 1)

    def comb2(a):
        return (a.astype(np.float64) * (a - 1) / 2).sum()

    same_both = comb2(cont)
    same_true = comb2(cont.sum(axis=1))
    same_pred = comb2(cont.sum(axis=0))
    total = n * (n - 1) / 2
    agreements = same_both + (total - same_true - same_pred + same_both)
    return float(agreements / total) if total else 1.0
