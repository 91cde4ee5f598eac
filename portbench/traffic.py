"""The general traffic generator: every mix is a data file
(``traffic/<mix>.json``) of parameters that these functions read. Inputs
come from ``--seed`` alone; every seed gets the same sizes and counts, in
another arrangement, so that the seed changes the values and not the
amount of work.

- ``make_clips``: synthetic footage (smooth background, per-frame noise,
  moving textured face-like blobs), written as MJPG AVI;
- ``make_crops``: face-like crops of a few synthetic identities, square,
  log-uniform sizes, a share of near-duplicates, written as JPEG;
- ``make_arrivals``: an open-loop schedule at a fixed rate, the gaps of
  Poisson arrivals and the frames per request each a fixed multiset in a
  seeded order.
"""

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _smooth(rng, hw, grid, lo=0, hi=256):
    import cv2

    h, w = hw
    small = rng.integers(lo, hi, (grid[0], grid[1], 3)).astype(np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def _face_patch(rng, size):
    """A face-like blob: a smooth skin-toned ellipse with two dark eyes and
    a mouth, on a smooth surround; uint8 BGR [size, size, 3] and its mask."""
    import cv2

    tone = np.array([rng.integers(60, 140), rng.integers(110, 180), rng.integers(160, 235)])
    patch = np.clip(_smooth(rng, (size, size), (4, 4), -25, 25).astype(np.int16) + tone,
                    0, 255).astype(np.uint8)
    mask = np.zeros((size, size), np.uint8)
    c = size // 2
    cv2.ellipse(mask, (c, c), (int(size * 0.38), int(size * 0.47)), 0, 0, 360, 255, -1)
    for dx in (-1, 1):
        cv2.circle(patch, (c + dx * size // 6, int(size * 0.42)), max(2, size // 14),
                   (30, 30, 40), -1)
    cv2.ellipse(patch, (c, int(size * 0.68)), (max(3, size // 7), max(1, size // 20)), 0, 0,
                360, (60, 50, 140), -1)
    return patch, mask


def write_mjpeg_avi(path, jpegs, w, h, fps):
    """An AVI file (RIFF, one MJPG video stream, an idx1 index) holding the
    JPEG-coded frames ``jpegs`` (bytes) at ``fps``."""
    import struct

    def chunk(tag, data):
        return tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) % 2 else b"")

    def lst(tag, body):
        return b"LIST" + struct.pack("<I", len(body) + 4) + tag + body

    n = len(jpegs)
    big = max(len(j) for j in jpegs)
    avih = struct.pack("<10I4I", int(round(1e6 / fps)), big * fps, 0, 0x10, n, 0, 1, big,
                       w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0, n,
                       big, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh)
                                                    + chunk(b"strf", strf)))
    frames, index, at = [], [], 4
    for j in jpegs:
        c = chunk(b"00dc", j)
        index.append(struct.pack("<4sIII", b"00dc", 0x10, at, len(j)))
        frames.append(c)
        at += len(c)
    movi = lst(b"movi", b"".join(frames))
    body = b"AVI " + hdrl + movi + chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def make_clip(path, rng, spec, pool):
    """One clip of ``spec``: size [w, h], fps, seconds, faces (moving blobs
    per clip), face_px [min, max] (log-uniform side), variants (distinct
    noisy backgrounds cycled over the frames), noise (+- per pixel),
    quality (JPEG). Frames are coded on ``pool``'s threads."""
    import cv2

    w, h = spec["size"]
    n = int(round(spec["fps"] * spec["seconds"]))
    base = _smooth(rng, (h, w), (6, 10)).astype(np.int16)
    amp = spec["noise"]
    backs = [np.clip(base + rng.integers(-amp, amp + 1, (h, w, 3), dtype=np.int16), 0, 255)
             .astype(np.uint8) for _ in range(spec["variants"])]
    lo, hi = spec["face_px"]
    faces = []
    for _ in range(spec["faces"]):
        s = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        patch, mask = _face_patch(rng, s)
        pos = np.array([rng.uniform(0, w - s), rng.uniform(0, h - s)])
        vel = rng.uniform(-6, 6, 2)
        faces.append((s, patch, mask > 0, pos, vel))

    def frame(i):
        img = backs[i % len(backs)].copy()
        for s, patch, mask, pos, vel in faces:
            p = pos + vel * i
            # bounce inside the frame
            x = int(abs((p[0] + (w - s)) % (2 * (w - s)) - (w - s)))
            y = int(abs((p[1] + (h - s)) % (2 * (h - s)) - (h - s)))
            img[y:y + s, x:x + s][mask] = patch[mask]
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, spec["quality"]])
        if not ok:
            raise RuntimeError("JPEG coding failed")
        return buf.tobytes()

    write_mjpeg_avi(path, list(pool.map(frame, range(n))), w, h, spec["fps"])
    return path


def make_clips(out_dir, seed, spec):
    """``spec["clips"]`` clips of ``spec`` under ``out_dir``, each from its
    own stream of the seed."""
    os.makedirs(out_dir, exist_ok=True)
    seqs = np.random.SeedSequence(seed).spawn(spec["clips"])
    paths = [osp.join(out_dir, "clip%02d.avi" % k) for k in range(spec["clips"])]
    with ThreadPoolExecutor(spec.get("threads", 8)) as pool:
        for path, sq in zip(paths, seqs):
            make_clip(path, np.random.default_rng(sq), spec, pool)
    return paths


def crop_images(seed, spec):
    """``spec["n"]`` uint8 BGR square crops of ``spec["identities"]``
    identities, sides log-uniform in ``spec["px"]``, a share
    ``spec["dup_share"]`` of near-duplicates (an earlier crop plus +-2
    noise). Returns (crops, identity labels)."""
    import cv2

    rng = np.random.default_rng(seed)
    n, ids = spec["n"], spec["identities"]
    lo, hi = spec["px"]
    bases = [_face_patch(rng, 96)[0] for _ in range(ids)]
    labels = np.arange(n) % ids
    rng.shuffle(labels)
    n_dup = int(round(spec["dup_share"] * n))
    dup_of = np.full(n, -1)
    dup_at = rng.choice(np.arange(1, n), n_dup, replace=False)
    dup_of[dup_at] = [rng.integers(0, k) for k in dup_at]
    crops = []
    for k in range(n):
        if dup_of[k] >= 0:
            src = crops[dup_of[k]]
            crops.append(np.clip(src.astype(np.int16) + rng.integers(-2, 3, src.shape),
                                 0, 255).astype(np.uint8))
            labels[k] = labels[dup_of[k]]
            continue
        s = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        own = _smooth(rng, (96, 96), (5, 5)).astype(np.float32)
        img = 0.5 * bases[labels[k]] + 0.5 * own + rng.uniform(-20, 20)
        img = cv2.resize(np.clip(img, 0, 255).astype(np.uint8), (s, s),
                         interpolation=cv2.INTER_LINEAR)
        crops.append(np.clip(img.astype(np.int16) + rng.integers(-6, 7, img.shape),
                             0, 255).astype(np.uint8))
    return crops, labels


def make_crops(out_dir, seed, spec):
    """``crop_images`` written as JPEG files ``%05d.jpg``; returns the
    sorted paths."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    crops, _ = crop_images(seed, spec)
    paths = [osp.join(out_dir, "%05d.jpg" % k) for k in range(len(crops))]
    with ThreadPoolExecutor(4) as pool:
        ok = list(pool.map(lambda a: cv2.imwrite(a[0], a[1], [cv2.IMWRITE_JPEG_QUALITY, 95]),
                           zip(paths, crops)))
    if not all(ok):
        raise RuntimeError("could not write the crops under %s" % out_dir)
    return paths


def make_arrivals(seed, rate, seconds, sizes):
    """An open-loop schedule of ``round(rate * seconds)`` requests over
    ``seconds``: the gaps between arrivals are the quantiles (i + 1/2) / n
    of the exponential distribution of ``rate`` (Poisson arrivals), and the
    frames of the requests the multiset ``sizes`` repeated to the count,
    both shuffled by the seed: every seed gets the same gaps and sizes in
    another order. Returns (send times from 0, frames per request)."""
    rng = np.random.default_rng(seed)
    n = int(round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    times = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    counts = np.resize(np.asarray(sizes), n)
    rng.shuffle(counts)
    return times, counts
