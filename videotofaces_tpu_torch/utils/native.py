"""ctypes binding for the repo-level native host library (native/v2f_host.cpp).

The source belongs to neither package; this loader compiles it lazily with
g++ on first use into its own library name under ``<repo>/build/`` (so it
never races another loader over one .so). Every entry point has a numpy
fallback so the package works without a toolchain. The native path is the
throughput mode; the cv2-based ahash in pipeline/dupes.py remains the
bit-exact parity mode.
"""

import ctypes
import os
import os.path as osp
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    src = osp.join(root, "native", "v2f_host.cpp")
    out_dir = osp.join(root, "build")
    so = osp.join(out_dir, "libv2f_host_torch.so")
    try:
        if not osp.isfile(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(out_dir, exist_ok=True)
            # build under a per-process name, then rename: concurrent test
            # workers never load a half-written library
            tmp = "%s.%d" % (so, os.getpid())
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.ahash64_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.hamming_all_pairs_nearest.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.hamming_prev_window.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.hamming_prev_window.restype = ctypes.c_int64
        lib.ahash64_batch.restype = None
        lib.hamming_all_pairs_nearest.restype = None
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        # no g++ / unloadable library: the numpy fallbacks take over
        _LIB = None
    return _LIB


def available():
    return _build_and_load() is not None


def pack_bits(hash_vectors):
    """[N, 64] {0,1} -> [N] uint64 (bit k = vector[k])."""
    h = np.asarray(hash_vectors, dtype=np.uint64)
    return (h << np.arange(64, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)


def ahash64_batch(imgs_bgr_u8):
    """Same-size BGR uint8 crops [N, H, W, 3] -> packed uint64 hashes [N]."""
    lib = _build_and_load()
    imgs = np.ascontiguousarray(imgs_bgr_u8)
    n, h, w = imgs.shape[:3]
    if lib is not None:
        out = np.empty(n, dtype=np.uint64)
        lib.ahash64_batch(imgs.ctypes.data, n, h, w, out.ctypes.data)
        return out
    # numpy fallback: same math (BT.601 gray, 8x8 adaptive average, > mean)
    gray = imgs @ np.asarray([0.114, 0.587, 0.299])
    ys = np.minimum((np.arange(9) * h) // 8, h)
    xs = np.minimum((np.arange(9) * w) // 8, w)
    cells = np.empty((n, 8, 8))
    for i in range(8):
        for j in range(8):
            y0, y1 = ys[i], max(ys[i + 1], ys[i] + 1)
            x0, x1 = xs[j], max(xs[j + 1], xs[j] + 1)
            cells[:, i, j] = gray[:, y0:y1, x0:x1].mean(axis=(1, 2))
    bits = cells.reshape(n, 64) > cells.reshape(n, 64).mean(axis=1, keepdims=True)
    return pack_bits(bits)


def hamming_prev_window(packed, thr, window=5, seed=()):
    """Sliding prev-``window`` dedup over KEPT hashes (dupes.py:18-48).

    ``packed``: [n] uint64 new hashes in arrival order. ``seed``: hashes
    already kept before this batch (only the last ``window`` matter).
    Returns (keep bool [n], dist int32 [n], ref int32 [n]); ``ref`` indexes
    the concatenated [seed..., packed...] namespace, -1 for the first face
    ever (kept unconditionally, no comparison made)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    seed = np.ascontiguousarray(seed, dtype=np.uint64)
    n = len(packed)
    lib = _build_and_load()
    if lib is not None:
        keep = np.empty(n, dtype=np.uint8)
        dist = np.empty(n, dtype=np.int32)
        ref = np.empty(n, dtype=np.int32)
        lib.hamming_prev_window(packed.ctypes.data, n, int(window), int(thr),
                                seed.ctypes.data, len(seed),
                                keep.ctypes.data, dist.ctypes.data,
                                ref.ctypes.data)
        return keep.astype(bool), dist, ref
    # numpy fallback: identical loop
    keep = np.zeros(n, bool)
    dist = np.full(n, 10000, np.int32)
    ref = np.full(n, -1, np.int32)
    all_h = np.concatenate([seed, packed])
    kept = list(range(len(seed)))
    for i in range(n):
        if not kept:
            keep[i] = True
            kept.append(len(seed) + i)
            continue
        win = kept[-window:]
        d = [bin(int(all_h[len(seed) + i] ^ all_h[j])).count("1") for j in win]
        b = int(np.argmin(d))
        dist[i], ref[i] = d[b], win[b]
        if d[b] > thr:
            keep[i] = True
            kept.append(len(seed) + i)
    return keep, dist, ref


def hamming_nearest_earlier(packed):
    """For each hash: (min distance, argmin) over earlier hashes; [0] = 10000."""
    lib = _build_and_load()
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    n = len(packed)
    if lib is not None:
        dist = np.empty(n, dtype=np.int32)
        ref = np.empty(n, dtype=np.int32)
        lib.hamming_all_pairs_nearest(packed.ctypes.data, n,
                                      dist.ctypes.data, ref.ctypes.data)
        return dist, ref
    dist = np.full(n, 10000, dtype=np.int32)
    ref = np.zeros(n, dtype=np.int32)
    for i in range(1, n):
        d = np.asarray([bin(int(packed[i] ^ packed[j])).count("1") for j in range(i)])
        ref[i] = int(d.argmin())
        dist[i] = int(d.min())
    return dist, ref
