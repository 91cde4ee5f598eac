"""Three-part duplicate removal with audit logs (counterpart of
videotofaces_tpu/pipeline/dupes.py).

Behavioral contract (reference dupes.py):

1. ``remove_dupes_nearest`` — during detection, each new face's 8x8 average
   hash is compared to the previous 5 *kept* hashes; hamming distance <= thr
   marks a duplicate (window [-5:], dupes.py:18-48).
2. ``remove_dupes_overall(..., "hash")`` — all-pairs hamming over survivors;
   a face is a duplicate if some EARLIER face is within thr (dupes.py:51-93).
3. ``remove_dupes_overall(..., "enc")`` — the same with cosine distances over
   embeddings (main.py:72-74).

Duplicates are deleted, or moved to intermediate/dupesN with log_dupesN.csv
when save_dupes is set. Hashes are packed as one uint64 per face; distances
are integer popcounts, computed by the native C++ library (utils/native.py);
without it, N > 256 hashes go to the Hamming Gram on the device, fewer to
the numpy fallback. Cosine distances run as a Gram matrix on the device.
"""

import os
import os.path as osp

import cv2
import numpy as np
import torch

from .. import config
from ..ops import distances as D
from ..utils import native as NV

_WINDOW = 5  # how many kept predecessors each new face is checked against


def ahash(img_bgr):
    """64-bit average hash, packed into one uint64 (bit k = cell k > mean).
    The gray/resize math uses cv2 for bit-exact parity with the reference
    (dupes.py:11-15)."""
    gray = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2GRAY)
    tiny = cv2.resize(gray, (8, 8))
    bits = (tiny > tiny.mean()).flatten()
    return int(NV.pack_bits(bits[None])[0])


def ahash_native(img_bgr):
    """Throughput-mode hash: the C++ fused gray/8x8-area-average kernel
    (numpy fallback inside), one pixel pass, no cv2 temporaries."""
    return int(NV.ahash64_batch(np.ascontiguousarray(img_bgr)[None])[0])


def hamming(a, b):
    """Popcount of two packed uint64 hashes."""
    return int(a ^ b).bit_count()


def remove_dupes_nearest(faces, hashes, hash_thr, layout):
    """Window dedup for one batch. ``faces``: list[(img, filename)];
    ``hashes``: running list[(packed_hash, filename)] of every face kept so
    far this video. Returns (kept faces, updated hashes).

    Parity mode (precision "highest"/"high", the default) hashes each crop
    with cv2, bit-exact with the reference; throughput mode ("default")
    uses the native fused hash + window kernel (native/v2f_host.cpp),
    numerically compatible but not bit-identical to cv2's 8x8 resize.
    """
    if config.get_precision_name() == "default" and faces:
        return _remove_dupes_nearest_native(faces, hashes, hash_thr, layout)
    kept, log = [], []
    for img, fn in faces:
        h = ahash(img)
        if not hashes:
            hashes.append((h, fn))
            kept.append((img, fn))
            continue
        window = hashes[-_WINDOW:]
        dists = [hamming(h, prev) for (prev, _) in window]
        best = int(np.argmin(dists))
        d, near_fn = dists[best], window[best][1]
        log.append((fn, near_fn, d, int(d <= hash_thr)))
        if d > hash_thr:
            hashes.append((h, fn))
            kept.append((img, fn))
        elif layout.save_dupes:
            # faces arrive already resized by the caller (detection's
            # process_frames_batch applies resize_to before dedup)
            cv2.imwrite(layout.intermediate("dupes1", fn), img)

    _write_dupes1_log(log, layout)
    return kept, hashes


def _remove_dupes_nearest_native(faces, hashes, hash_thr, layout):
    """Throughput-mode window dedup: batch hashing + the C++ window kernel
    (same keep/drop semantics as the parity loop above)."""
    new_h = np.asarray([ahash_native(img) for img, _ in faces], np.uint64)
    seed = [h for h, _ in hashes[-_WINDOW:]]
    keep, dist, ref = NV.hamming_prev_window(new_h, hash_thr, _WINDOW, seed)
    names = [fn for _, fn in hashes[-_WINDOW:]] + [fn for _, fn in faces]

    kept, log = [], []
    for i, (img, fn) in enumerate(faces):
        if ref[i] >= 0:
            log.append((fn, names[ref[i]], int(dist[i]), int(not keep[i])))
        if keep[i]:
            hashes.append((int(new_h[i]), fn))
            kept.append((img, fn))
        elif layout.save_dupes:
            cv2.imwrite(layout.intermediate("dupes1", fn), img)
    _write_dupes1_log(log, layout)
    return kept, hashes


def _write_dupes1_log(log, layout):
    if layout.save_dupes and log:
        log_fn = layout.intermediate("log_dupes1.csv")
        fresh = not osp.exists(log_fn)
        with open(log_fn, "a") as f:
            if fresh:
                f.write("file_name,nearest_in_prev_5,hash_diff,marked_as_duplicate\n")
            for row in log:
                f.write("%s,%s,%u,%u\n" % row)


def _nearest_earlier(x, measure_type, device):
    """(min distance, argmin index) over all EARLIER rows, per row."""
    if measure_type == "hash":
        packed = np.ascontiguousarray(x, dtype=np.uint64)
        if NV.available() or len(packed) <= 256:
            return NV.hamming_nearest_earlier(packed)   # native C++ or numpy
        # no native library: the device Hamming Gram beats the O(N^2)
        # python loop once N is non-trivial
        bits = ((packed[:, None] >> np.arange(64, dtype=np.uint64)) & 1).astype(np.uint8)
        mins, inds = D.dedup_hash(torch.from_numpy(bits).to(config.resolve_device(device)))
        return mins.cpu().numpy(), inds.cpu().numpy()
    feats = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    mins, inds = D.dedup_cosine(feats.to(config.resolve_device(device)))
    return mins.cpu().numpy(), inds.cpu().numpy()


def remove_dupes_overall(x, filenames, measure_type, threshold, layout, device=None):
    """All-pairs dedup against earlier faces. ``x``: [N] packed uint64
    hashes or [N, D] embeddings; the cosine Gram, and the hash Gram when
    the native library is unavailable and N > 256, run on ``device``
    (None: the card). Returns (x without duplicates, surviving names)."""
    if len(filenames) == 0:
        return x, filenames

    mins, inds = _nearest_earlier(x, measure_type, device)
    is_dup = mins <= threshold
    is_dup[0] = False  # row 0 has no earlier face (sentinel distance 10000)

    dupes = [fn for fn, d in zip(filenames, is_dup) if d]
    goods = [fn for fn, d in zip(filenames, is_dup) if not d]
    x = np.asarray(x)[~is_dup]

    if not layout.save_dupes:
        for fn in dupes:
            p = layout.face_path(osp.basename(fn))
            if osp.isfile(p):
                os.remove(p)
    else:
        part, colname = ("2", "hash_diff") if measure_type == "hash" else ("3", "distance")
        dup_dir = layout.intermediate("dupes" + part)
        os.makedirs(dup_dir, exist_ok=True)
        for fn in dupes:
            base = osp.basename(fn)
            if osp.isfile(layout.face_path(base)):
                os.replace(layout.face_path(base), osp.join(dup_dir, base))
        with open(layout.intermediate("log_dupes%s.csv" % part), "w") as f:
            f.write("file_name,nearest_in_prev,%s,marked_as_duplicate\n" % colname)
            for i in range(1, len(filenames)):
                f.write("%s,%s,%s,%s\n" % (filenames[i], filenames[inds[i]],
                                           str(mins[i]), "1" if is_dup[i] else "0"))

    if measure_type != "hash" and is_dup.any():
        print("Removed %u near-duplicates" % int(is_dup.sum()))
    return x, goods
