"""The port's grouping ops — cosine / Hamming Gram matrices and dedup
reductions, k-means (host k-means++ and device Lloyd steps) and the cluster
scores — against the JAX package's on the same seeded numpy inputs, on the
CPU, in precision "highest"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.ops import cluster_scores as JCS
from videotofaces_tpu.ops import distances as JD
from videotofaces_tpu.ops import kmeans as JKM
from videotofaces_tpu_torch.ops import cluster_scores as CS
from videotofaces_tpu_torch.ops import distances as D
from videotofaces_tpu_torch.ops import kmeans as KM

# float32 on both sides; matmul and reduction order differ
RTOL = 1e-5


def _blobs(seed, n_per=25, k=6, d=32, spread=0.4):
    """Well-separated seeded clusters of unit vectors (as the embeddings
    are), so that labels compare exactly."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (k, d))
    pts = np.concatenate([c + rng.normal(0, spread, (n_per, d)) for c in centers])
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts[rng.permutation(len(pts))].astype(np.float32)


def _grid_blobs(seed, n_per=20, k=6, d=32):
    """Seeded clusters on a 1/8 grid: every square, product and partial sum
    of the ``x2 - 2xy + y2`` distances is exact in float32, so the scores
    differ between the two packages by summation order only. (On
    off-grid data both are ~1e-5 from the float64 value: a point's distance
    to itself comes out as the square root of a rounding residue.)"""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (k, d))
    pts = np.concatenate([c + rng.normal(0, 1.0, (n_per, d)) for c in centers])
    return (np.round(pts * 8) / 8)[rng.permutation(len(pts))].astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    return _blobs(0)


def test_cosine_gram_and_dedup_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (40, 16)).astype(np.float32)
    x[7] = 0.0                               # a zero row stays zero
    x[12] = x[3] * 2.5                        # colinear: distance 0 to row 3
    y = rng.normal(0, 1, (5, 16)).astype(np.float32)
    np.testing.assert_allclose(D.cosine_gram(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(JD.cosine_gram(jnp.asarray(x), jnp.asarray(y))),
                               rtol=0, atol=1e-6)
    mins, inds = D.dedup_cosine(torch.from_numpy(x))
    jmins, jinds = JD.dedup_cosine(x)
    np.testing.assert_allclose(mins.numpy(), np.asarray(jmins), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(inds.numpy()[1:], np.asarray(jinds)[1:])
    assert inds[12] == 3 and mins[12] < 1e-6 and mins[0] >= 10000 - 1


def test_hamming_dedup_matches_jax():
    bits = np.random.default_rng(2).integers(0, 2, (30, 64)).astype(np.uint8)
    bits[9] = bits[4]
    np.testing.assert_array_equal(D.hamming_gram(torch.from_numpy(bits)).numpy(),
                                  np.asarray(JD.hamming_gram(jnp.asarray(bits))))
    mins, inds = D.dedup_hash(torch.from_numpy(bits))
    jmins, jinds = JD.dedup_hash(jnp.asarray(bits))
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmins))
    np.testing.assert_array_equal(inds.numpy()[1:], np.asarray(jinds)[1:])
    assert mins.dtype == torch.int32 and mins[9] == 0 and inds[9] == 4


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_plusplus_indices_equal_jax(blobs, seed):
    _, got = KM.kmeans_plusplus(blobs, 6, seed)
    _, want = JKM.kmeans_plusplus(blobs, 6, seed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", range(2, 10))
def test_kmeans_fit_matches_jax(blobs, k):
    labels, centers, inertia = KM.kmeans_fit(blobs, k, random_state=0, device="cpu")
    jl, jc, ji = JKM.kmeans_fit(blobs, k, random_state=0)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_allclose(centers, jc, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(inertia, ji, rtol=RTOL)


def test_kmeans_fit_relocates_empty_clusters_as_jax():
    """Three distinct points repeated: k-means++ runs out of potential and
    seeds a duplicate center, whose cluster is empty after the first
    assignment and is relocated to the farthest point. Every point's
    distance to its center is 0 up to rounding, so which point counts as
    farthest is rounding noise: the relocated center is held to be a data
    point, the others to the JAX centers."""
    rng = np.random.default_rng(5)
    base = rng.normal(0, 1, (3, 8)).astype(np.float32)
    x = base[np.arange(12) % 3]
    labels, centers, inertia = KM.kmeans_fit(x, 4, random_state=0, device="cpu")
    jl, jc, ji = JKM.kmeans_fit(x, 4, random_state=0)
    np.testing.assert_array_equal(labels, jl)
    used = np.unique(labels)
    assert len(used) == 3                         # one cluster stays empty
    np.testing.assert_allclose(centers[used], jc[used], rtol=RTOL, atol=1e-6)
    empty = np.setdiff1d(np.arange(4), used)[0]
    assert (np.abs(base - centers[empty]).max(axis=1) == 0).any()
    assert inertia == pytest.approx(ji, abs=1e-5)


def test_kmeans_fit_degenerate_as_jax():
    x = _blobs(2, n_per=1, k=4, d=8)
    for k in (4, 6):                              # n_clusters >= n
        labels, centers, inertia = KM.kmeans_fit(x, k, random_state=0, device="cpu")
        jl, jc, ji = JKM.kmeans_fit(x, k, random_state=0)
        np.testing.assert_array_equal(labels, jl)
        np.testing.assert_array_equal(centers, jc)
        assert inertia == ji == 0.0


@pytest.mark.parametrize("k", [2, 6, 9])
def test_cluster_scores_match_jax(k):
    x = _grid_blobs(0)
    labels = JKM.kmeans_fit(x, k, random_state=0)[0]
    for port, jax_fn in [(CS.silhouette_score, JCS.silhouette_score),
                         (CS.calinski_harabasz_score, JCS.calinski_harabasz_score),
                         (CS.davies_bouldin_score, JCS.davies_bouldin_score)]:
        got = port(x, labels, k, device="cpu")
        assert got == pytest.approx(jax_fn(x, labels, k), rel=RTOL), port.__name__


def test_silhouette_with_singletons_and_row_blocks(monkeypatch):
    """Singleton clusters score 0, and the row-blocked distance sum equals
    one block."""
    x = _grid_blobs(6, n_per=7, k=3, d=5)
    labels = JKM.kmeans_fit(x, 3, random_state=0)[0].copy()
    labels[0] = 3                                 # a singleton cluster
    want = JCS.silhouette_score(x, labels, 4)
    assert CS.silhouette_score(x, labels, 4, device="cpu") == pytest.approx(want, rel=RTOL)
    monkeypatch.setattr(CS, "_SIL_ROWS", 4)
    assert CS.silhouette_score(x, labels, 4, device="cpu") == pytest.approx(want, rel=RTOL)


def test_rand_score_equals_jax():
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, 4, 100), rng.integers(0, 3, 100)
    assert CS.rand_score(a, b) == JCS.rand_score(a, b)
    assert CS.rand_score(a, a) == 1.0


def test_device_none_means_the_card(monkeypatch, blobs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        KM.kmeans_fit(blobs, 3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CS.silhouette_score(blobs, np.zeros(len(blobs), int), 2)


def test_hash_dedup_without_native_library_uses_the_device_gram(monkeypatch, tmp_path):
    """N = 300 > 256 hashes with planted near-duplicates and the native
    library unavailable: the all-pairs hash dedup runs ``dedup_hash`` on the
    given device (never the O(N^2) python loop) and equals the JAX
    package's ``_nearest_earlier`` and the native path; ``remove_dupes_overall``
    keeps the same names as the JAX package's."""
    from videotofaces_tpu import specs as JS
    from videotofaces_tpu.pipeline import dupes as JDUP
    from videotofaces_tpu_torch import specs as TS
    from videotofaces_tpu_torch.pipeline import dupes as TDUP
    from videotofaces_tpu_torch.utils import native as TNV

    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (300, 64)).astype(np.uint8)
    for i in rng.choice(np.arange(20, 300), 40, replace=False):   # near-duplicates
        bits[i] = bits[rng.integers(0, i)]
        bits[i, rng.choice(64, rng.integers(0, 6), replace=False)] ^= 1
    packed = TNV.pack_bits(bits)
    names = ["f%03d.jpg" % i for i in range(len(packed))]
    native = TNV.hamming_nearest_earlier(packed)
    jax_mins, jax_inds = JDUP._nearest_earlier(packed, "hash")
    jax_kept = JDUP.remove_dupes_overall(packed, names, "hash", 4,
                                         JS.OutputLayout(str(tmp_path / "jax")))[1]

    def python_loop(_):
        raise AssertionError("the python O(N^2) loop ran")

    devices = []
    gram = D.dedup_hash
    monkeypatch.setattr(TNV, "available", lambda: False)
    monkeypatch.setattr(TNV, "hamming_nearest_earlier", python_loop)
    monkeypatch.setattr(D, "dedup_hash", lambda x: devices.append(x.device) or gram(x))
    mins, inds = TDUP._nearest_earlier(packed, "hash", "cpu")
    assert devices == [torch.device("cpu")]
    for want_mins, want_inds in ((jax_mins, jax_inds), native):
        np.testing.assert_array_equal(mins[1:], np.asarray(want_mins)[1:])
        np.testing.assert_array_equal(inds[1:], np.asarray(want_inds)[1:])
    assert (mins[1:] <= 4).sum() >= 30
    kept = TDUP.remove_dupes_overall(packed, names, "hash", 4,
                                     TS.OutputLayout(str(tmp_path / "port")), "cpu")[1]
    assert kept == jax_kept and len(kept) < len(names) - 30
    assert len(devices) == 2


def _near_tied(seed, n=18, d=32):
    """Embeddings like the pipeline tests' stand-in encoder's: a one-hot
    brightness bucket plus 0.01 x brightness / 255 in every column, for
    crops of brightness 100 or 160 (+ up to 2): the points of a bucket lie
    ~1e-5 apart — closer than float32's error in the ``x2 - 2xy + y2``
    distances of vectors of norm ~3."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, d), np.float32)
    for i, m in enumerate(np.where(rng.random(n) < 0.5, 100.0, 160.0) + rng.uniform(0, 2, n)):
        bucket = int(m // 64)
        x[i, bucket * 8:bucket * 8 + 8] = 1.0
        x[i] += np.float32(m / 255.0 * 0.01)
    return x


def _lloyd_float64(x, k, seed):
    """Lloyd's algorithm in float64 from the same k-means++ seeding, to the
    first repeated labelling."""
    x = x.astype(np.float64)
    centers = KM.kmeans_plusplus(x.astype(np.float32), k, seed)[0].astype(np.float64)
    prev = None
    for _ in range(300):
        labels = ((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
        if prev is not None and (labels == prev).all():
            break
        centers = np.stack([x[labels == j].mean(0) if (labels == j).any() else centers[j]
                            for j in range(k)])
        prev = labels
    return labels


def _scores_float64(x, labels, k):
    """The three scores in float64 with distances as differences (sklearn's
    own euclidean distances use the expansion, which errs at ~1e-5 here):
    silhouette on the precomputed distance matrix, Calinski-Harabasz
    (no distances), Davies-Bouldin as its definition."""
    from sklearn import metrics

    x = x.astype(np.float64)
    dist = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    centers = np.stack([x[labels == j].mean(0) for j in range(k)])
    s = np.array([np.sqrt(((x[labels == j] - centers[j]) ** 2).sum(1)).mean()
                  for j in range(k)])
    m = np.sqrt(((centers[:, None] - centers[None]) ** 2).sum(-1))
    r = (s[:, None] + s[None]) / np.where(m == 0, np.inf, m)
    np.fill_diagonal(r, -np.inf)
    return [metrics.silhouette_score(dist, labels, metric="precomputed"),
            metrics.calinski_harabasz_score(x, labels), r.max(1).mean()]


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_and_scores_on_near_tied_points_equal_float64(seed):
    """Points ~1e-5 apart: the labels equal a float64 Lloyd's and the three
    scores their float64 values (rtol 1e-4), where float32 distances flip
    labels from one Lloyd step to the next and move the scores by
    percent."""
    x = _near_tied(seed)
    for k in (3, 4):
        labels = KM.kmeans_fit(x, k, random_state=0, device="cpu")[0]
        np.testing.assert_array_equal(labels, _lloyd_float64(x, k, 0))
        np.testing.assert_allclose(
            [CS.silhouette_score(x, labels, k, device="cpu"),
             CS.calinski_harabasz_score(x, labels, k, device="cpu"),
             CS.davies_bouldin_score(x, labels, k, device="cpu")],
            _scores_float64(x, labels, k), rtol=1e-4)
