"""The plain reference of the pipeline around the models, in NumPy and
OpenCV: frame sampling and decoding, the box filter and crop rules, the
average-hash window dedup, the embedding dedup, K-means with k-means++
seeding (sklearn's algorithm) and the silhouette. Written from the
published behaviour of the pipeline (videotofaces' detection.py /
dupes.py / grouping.py); nothing here imports the program."""

import numpy as np

WINDOW = 5   # kept predecessors each new face is checked against


# -- frames ------------------------------------------------------------------


def frame_schedule(length, fps, video_step):
    """Sampled frame indices: range(step, length, step), step = round(fps *
    video_step) frames."""
    step = max(round(fps * video_step), 1)
    return list(range(step, length, step))


def read_frames(path, video_step, limit=None):
    """(indices, BGR frames) of the sampled frames, decoded in order (the
    first ``limit`` of them)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        length = round(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = round(cap.get(cv2.CAP_PROP_FPS))
        want = set(frame_schedule(length, fps, video_step))
        idx, frames = [], []
        for i in range(length):
            ok, frame = cap.read()
            if not ok:
                break
            if i in want:
                idx.append(i)
                frames.append(frame)
                if limit is not None and len(idx) == limit:
                    break
        return idx, frames
    finally:
        cap.release()


def frames_at(path, indices):
    """The BGR frames at ``indices`` (seeking; MJPG frames stand alone)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        out = []
        for i in indices:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError("cannot read frame %d of %s" % (i, path))
            out.append(frame)
        return out
    finally:
        cap.release()


def spread_frames(paths, video_step, n):
    """``n`` sampled frames spread evenly over the clips ``paths``."""
    import cv2

    per = -(-n // len(paths))
    out = []
    for path in paths:
        cap = cv2.VideoCapture(path)
        length, fps = round(cap.get(cv2.CAP_PROP_FRAME_COUNT)), round(cap.get(cv2.CAP_PROP_FPS))
        cap.release()
        idx = frame_schedule(length, fps, video_step)
        out += frames_at(path, [idx[k] for k in np.linspace(0, len(idx) - 1, per).astype(int)])
    return out[:n]


# -- the box rules -----------------------------------------------------------


def round_out(boxes):
    b = np.asarray(boxes, np.float64).reshape(-1, 4)
    b = np.where(np.isfinite(b), b, 0.0)
    return np.stack([np.floor(b[:, 0]), np.floor(b[:, 1]),
                     np.ceil(b[:, 2]), np.ceil(b[:, 3])], axis=1).astype(np.int64)


def passes(iboxes, scores, hw, min_score, min_size, min_border):
    h, w = hw
    ok = np.asarray(scores) >= min_score
    ok &= (iboxes[:, 2] - iboxes[:, 0] >= min_size) & (iboxes[:, 3] - iboxes[:, 1] >= min_size)
    if min_border:
        ok &= ((iboxes[:, 0] >= min_border) & (iboxes[:, 1] >= min_border)
               & (iboxes[:, 2] <= w - min_border) & (iboxes[:, 3] <= h - min_border))
    return ok


def _grow(lo, hi, grow, limit):
    lo, hi = lo - grow // 2, hi + (grow - grow // 2)
    if lo < 0:
        hi = min(limit, hi - lo)
        lo = 0
    if hi > limit:
        lo = max(0, lo - (hi - limit))
        hi = limit
    return lo, hi


def adjust_box(box, hw, scale, square):
    """Scale one integer box about its centre by (left, right, up, down)
    factors, then square it inside the frame."""
    import math

    h, w = hw
    sx1, sx2, sy1, sy2 = scale
    x1, y1, x2, y2 = (float(v) for v in box)
    bw, bh = x2 - x1, y2 - y1
    xc, yc = x1 + bw / 2, y1 + bh / 2
    x1, x2 = math.floor(max(0, xc - sx1 * bw / 2)), math.ceil(min(w, xc + sx2 * bw / 2))
    y1, y2 = math.floor(max(0, yc - sy1 * bh / 2)), math.ceil(min(h, yc + sy2 * bh / 2))
    if square:
        bw, bh = x2 - x1, y2 - y1
        if bh > bw:
            x1, x2 = _grow(x1, x2, bh - bw, w)
        elif bw > bh:
            y1, y2 = _grow(y1, y2, bw - bh, h)
        bw, bh = x2 - x1, y2 - y1
        if bw > h:
            d = bw - h
            x1, x2 = x1 + d // 2, x2 - (d - d // 2)
        elif bh > w:
            d = bh - w
            y1, y2 = y1 + d // 2, y2 - (d - d // 2)
    return x1, y1, x2, y2


def frame_crops(frame, index, boxes, scores, criteria):
    """The named crops of one frame: [(name, crop)] in detection order."""
    hw = frame.shape[:2]
    ib = round_out(boxes)
    ok = passes(ib, scores, hw, criteria["min_score"], criteria["min_size"],
                criteria["min_border"])
    out = []
    for j, box in enumerate(ib[ok]):
        x1, y1, x2, y2 = adjust_box(box, hw, criteria["scale"], criteria["square"])
        crop = frame[y1:y2, x1:x2]
        if crop.size:
            out.append(("%06d_%u.jpg" % (index, j), crop))
    return out


# -- dedup -------------------------------------------------------------------


def ahash_bits(img_bgr):
    """The 64 average-hash bits: 8 x 8 area of the gray image > its mean."""
    import cv2

    tiny = cv2.resize(cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY), (8, 8))
    return (tiny > tiny.mean()).flatten()


def window_dedup(named_crops, thr):
    """Keep a face unless one of the last WINDOW kept faces of the clip is
    within ``thr`` Hamming distance of its hash. Returns the kept
    [(name, crop)]."""
    kept, hashes = [], []
    for name, crop in named_crops:
        h = ahash_bits(crop)
        if hashes and min(int((h != p).sum()) for p in hashes[-WINDOW:]) <= thr:
            continue
        hashes.append(h)
        kept.append((name, crop))
    return kept


def cosine_dedup_keep(x, thr):
    """[N] bool: rows whose cosine distance to every earlier row exceeds
    ``thr`` (row 0 always kept), in float64."""
    x = np.asarray(x, np.float64)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.where(n == 0, 1.0, n)
    d = 1.0 - xn @ xn.T
    keep = np.ones(len(x), bool)
    for i in range(1, len(x)):
        keep[i] = d[i, :i].min() > thr
    return keep


# -- K-means and the silhouette ------------------------------------------------


def kmeans_plusplus(x, k, random_state):
    """sklearn's greedy k-means++ seeding with its RandomState draws in
    their published order. Returns the seed indices."""
    rs = np.random.RandomState(random_state)
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    x_sq = np.einsum("ij,ij->i", x, x)

    def d2(rows):
        return np.maximum(x_sq[rows][:, None] - 2 * (x[rows] @ x.T) + x_sq[None, :], 0)

    idx = [rs.choice(n, p=np.full(n, 1.0 / n))]
    closest = d2(np.asarray(idx))[0]
    pot = closest.sum()
    for _ in range(1, k):
        cand = np.searchsorted(np.cumsum(closest), rs.uniform(size=trials) * pot)
        np.clip(cand, None, n - 1, out=cand)
        dists = np.minimum(closest, d2(cand))
        pots = dists.sum(axis=1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], dists[best]
        idx.append(int(cand[best]))
    return np.asarray(idx)


def _assign(x64, centers):
    c = centers.astype(np.float64)
    d = np.maximum((x64 * x64).sum(1)[:, None] - 2.0 * (x64 @ c.T) + (c * c).sum(1)[None], 0.0)
    return d.argmin(axis=1), d.min(axis=1)


def kmeans(x, k, random_state=0, max_iter=300, tol=1e-4):
    """Lloyd from k-means++ seeds: assignment on float64 distances, centres
    as float32 means, sklearn's stop rules (labels repeat, or the summed
    squared centre shift <= tol x mean variance) and empty clusters
    re-seeded from the farthest points. Returns the labels."""
    x = np.ascontiguousarray(x, np.float32)
    x64 = x.astype(np.float64)
    centers = x[kmeans_plusplus(x, k, random_state)].copy()
    tol_abs = tol * float(np.mean(np.var(x, axis=0)))
    prev = None
    for _ in range(max_iter):
        labels, closest = _assign(x64, centers)
        onehot = np.eye(k, dtype=np.float32)[labels]
        counts = onehot.sum(0)
        new = (onehot.T @ x) / np.maximum(counts, 1.0)[:, None]
        new = np.where((counts == 0)[:, None], centers, new).astype(np.float32)
        if (counts == 0).any():
            far = np.argsort(-closest.astype(np.float32), kind="stable")
            for slot, cid in enumerate(np.nonzero(counts == 0)[0]):
                new[cid] = x[far[slot]]
        shift = float(((new.astype(np.float64) - centers) ** 2).sum())
        centers = new
        if prev is not None and np.array_equal(labels, prev):
            return labels
        prev = labels
        if shift <= tol_abs:
            break
    return _assign(x64, centers)[0]


def silhouette(x, labels, k):
    """The mean silhouette (euclidean, float64)."""
    x = np.asarray(x, np.float64)
    sq = (x * x).sum(1)
    d = np.sqrt(np.maximum(sq[:, None] - 2.0 * (x @ x.T) + sq[None, :], 0.0))
    np.fill_diagonal(d, 0.0)
    onehot = np.eye(k)[labels]
    counts = onehot.sum(0)
    sums = d @ onehot
    own = counts[labels]
    a = sums[np.arange(len(x)), labels] / np.maximum(own - 1.0, 1.0)
    other = sums / np.maximum(counts, 1.0)[None]
    other[np.arange(len(x)), labels] = np.inf
    other[:, counts == 0] = np.inf
    b = other.min(1)
    s = (b - a) / np.maximum(np.maximum(a, b), 1e-30)
    s[own == 1] = 0.0
    return float(s.mean())
