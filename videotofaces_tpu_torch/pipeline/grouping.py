"""Grouping stage: embeddings -> K-means clusters or reference classification
(counterpart of videotofaces_tpu/pipeline/grouping.py, one device).

Behavioral contract (reference grouping.py):
- ``encode_faces``: batched encode of face images read from disk, with the
  optional fractional ``enc_area`` crop (grouping.py:29-40);
- ``classify_faces``: cosine argmin against one reference embedding per class,
  "other" class when min distance >= threshold, files moved via os.replace,
  optional ``faces/log_classification.csv`` (grouping.py:50-89);
- ``cluster_faces``: K-means for each candidate k (random_state-reproducible,
  sklearn-parity), silhouette / Calinski-Harabasz / Davies-Bouldin scores,
  best k by silhouette, copies into ``G<k>/<label>/`` (or ``<label>/``),
  originals deleted, optional ``faces/log_clustering.csv`` (grouping.py:92-137);
- ``test_grouping``: eval harness against ``out_dir/labels.txt`` printing
  accuracy / rand score / silhouette (grouping.py:140-172).

Device work (embeddings, cosine Gram matrices, K-means, scores) runs on the
card, or on the CPU when the caller passes ``device="cpu"``; this module is
the host orchestration: batching images to the encoder and distributing
files into group folders. Stage timings are reported per run.
In a multi-host job every host passes the gathered set (every host's
faces) to ``cluster_faces`` / ``classify_faces``: the labels are identical
everywhere, and a file that is not there (another host's, or one that a
host sharing ``out_dir`` moved first) is skipped.
"""

import os
import os.path as osp
import shutil

import cv2
import numpy as np
import torch

from .. import config
from ..ops import cluster_scores as CS
from ..ops import distances as D
from ..ops.kmeans import kmeans_fit
from ..utils.image import crop_to_area
from ..utils.pbar import tqdm
from ..utils.profiling import StageTimer, recording, trace
from . import mesh_auto
from .dupes import skip_missing

_ENCODERS = ("facenet_vgg", "facenet_casia", "vit_b", "vit_l")


def resolve_enc_model(style, enc_model):
    """The encoder name ``enc_model`` stands for ("default" picks per
    style); raises for an unknown name."""
    if enc_model == "default":
        enc_model = "vit_b" if style == "anime" else "facenet_vgg"
    if enc_model not in _ENCODERS:
        raise ValueError("unknown enc_model %r (valid: default, facenet_vgg, "
                         "facenet_casia, vit_b, vit_l)" % (enc_model,))
    return enc_model


def get_encoder_model(style, enc_model, device=None, mesh="auto", **model_kw):
    """String-dispatch encoder factory (reference grouping.py:19-26): FaceNet
    (VGGFace2 or CASIA weights) or ViT (B16 or L16). ``model_kw``
    (``params``, ``batch_size``, ``device_resize``, ``pack_size``) go to the
    encoder. ``mesh``: a ``parallel.Mesh`` shards encoding over its devices;
    ``"auto"`` and None keep one device (pipeline/mesh_auto.py)."""
    from ..models.wrappers import FaceNetEncoder, VitEncoder

    name = resolve_enc_model(style, enc_model)
    mesh = mesh_auto.resolve_mesh(mesh)
    if name.startswith("vit"):
        return VitEncoder(device, name == "vit_l", mesh=mesh, **model_kw)
    return FaceNetEncoder(device, name == "facenet_casia", mesh=mesh, **model_kw)


def _batched(seq, size):
    for i in range(0, len(seq), size):
        yield seq[i:i + size]


def _read_batches(paths, batch_size, images=None):
    """Yields image batches for encoding. Disk reads happen on a small thread
    pool one batch ahead of the consumer (cv2.imread releases the GIL), so
    JPEG decode overlaps device compute. ``images``: optional in-memory crops
    keyed by basename (``enc_from_memory``) — no disk IO at all."""
    if images is not None:
        for group in _batched(paths, batch_size):
            yield [images[osp.basename(p)] for p in group]
        return

    from concurrent.futures import ThreadPoolExecutor

    groups = list(_batched(paths, batch_size))
    with ThreadPoolExecutor(max_workers=min(8, max(2, (os.cpu_count() or 1)))) as pool:
        def read_group(group):
            return list(pool.map(cv2.imread, group))

        pending = pool.submit(read_group, groups[0]) if groups else None
        for i in range(len(groups)):
            batch = pending.result()
            pending = pool.submit(read_group, groups[i + 1]) if i + 1 < len(groups) else None
            yield batch


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")


def encode_faces(paths, model, batch_size, area, images=None):
    """Embed face crops in batches on the encoder's device. Crops come from
    disk (prefetched on a reader pool) or, when ``images`` maps basename ->
    array, straight from memory (the encoder then sees pre-compression
    pixels)."""
    print("Extracting features from images for grouping")
    if not paths:
        return np.zeros((0, 1), np.float32)
    if getattr(model, "batch_size", False) is None:
        model.batch_size = batch_size
    timer = StageTimer()
    chunks = []
    with recording(timer), trace(), tqdm(total=len(paths)) as pbar:
        reader = iter(_read_batches(paths, batch_size, images))
        while True:
            with timer.stage("encode:read"):  # wait on the prefetched read
                batch = next(reader, None)
                if batch is not None and area:
                    batch = [crop_to_area(img, area) for img in batch]
            if batch is None:
                break
            with timer.stage("encode:forward", items=len(batch)):
                chunks.append(model(batch))
            pbar.update(chunks[-1].shape[0])
    timer.report()
    return np.concatenate(chunks)


def encode_refs(refs, model):
    """One embedding per class: the first reference image of each."""
    return model([cv2.imread(paths[0]) for (_, paths) in refs])


def classify(x, r, classes, thr, log, paths, out_dir, device=None):
    """Cosine argmin vs reference embeddings on ``device`` (None: the card);
    optional 'other' open set."""
    dev = config.resolve_device(device)
    dist = D.cosine_gram(torch.from_numpy(np.asarray(x, np.float32)).to(dev),
                         torch.from_numpy(np.asarray(r, np.float32)).to(dev)).cpu().numpy()
    assigned = dist.argmin(axis=1)
    open_set = bool(thr) and thr != -1
    if open_set:
        assigned = np.where(dist.min(axis=1) >= thr, len(classes), assigned)
        classes = classes + ["other"]
    if log:
        known = [c for c in classes if c != "other"]
        tail = "assigned_to_class" + ("(other_threshold=%s)" % str(thr) if thr else "")
        rows = [[osp.basename(p)] + ["%.4f" % v for v in dist[i]] + [classes[assigned[i]]]
                for i, p in enumerate(paths)]
        _write_csv(osp.join(out_dir, "faces", "log_classification.csv"),
                   ",".join(["file_name"] + ["dist_" + c for c in known] + [tail]),
                   rows)
    return assigned, classes


def _print_group_sizes(title, labels, names=None):
    values, counts = np.unique(labels, return_counts=True)
    parts = ["%s: %u" % (names[v] if names else str(v), c)
             for v, c in zip(values, counts)]
    print((title + ": " if title else "") + ", ".join(parts))


def classify_faces(paths, x, model, spec, out_dir):
    """Assign each face to its nearest reference class and move the files
    (spec: specs.ClassifySpec). Distances run on the encoder's device."""
    classes = [name for (name, _) in spec.refs]
    print("Found %u classes in ref_dir: %s" % (len(classes), ", ".join(classes)))
    print("Extracting features from reference images")
    r = encode_refs(spec.refs, model)
    print("Classifying images")
    assigned, classes = classify(x, r, classes, spec.other_thr, spec.write_log,
                                 paths, out_dir, model.device)

    base = osp.dirname(osp.abspath(paths[0]))
    for c in classes:
        os.makedirs(osp.join(base, c), exist_ok=True)
    for p, lbl in zip(paths, assigned):
        skip_missing(os.replace, p, osp.join(base, classes[lbl], osp.basename(p)))

    print("Grouped %u images into %u folders:" % (len(paths), len(classes)))
    for i, c in enumerate(classes):
        print(c + ": " + str(int(np.count_nonzero(assigned == i))))
    print()


def cluster_faces(paths, x, spec, out_dir, device=None):
    """K-means over the embeddings for each candidate k on ``device`` (None:
    the card); keep the best k by silhouette (or every k under G<k>/ when
    spec.keep_all). spec is a specs.ClusterSpec."""
    candidates = [k for k in spec.candidates if k <= len(paths)]
    if not candidates:
        print("NOTE: only %u face(s) survived — fewer than every requested cluster "
              "count (%s); leaving them ungrouped in faces/"
              % (len(paths), ", ".join(str(k) for k in spec.candidates)))
        return
    print("Clustering images into %s groups" % ", ".join(str(k) for k in candidates))

    timer = StageTimer()
    runs = []  # (k, labels, silhouette, calinski-harabasz, davies-bouldin)
    with recording(timer):
        for k in candidates:
            with timer.stage("cluster:kmeans k=%d" % k, items=len(paths)):
                labels = kmeans_fit(x, k, random_state=spec.random_state, device=device)[0]
            with timer.stage("cluster:scores"):
                runs.append((k, labels,
                             CS.silhouette_score(x, labels, k, device=device),
                             CS.calinski_harabasz_score(x, labels, k, device=device),
                             CS.davies_bouldin_score(x, labels, k, device=device)))
    if spec.write_log:
        _write_csv(osp.join(out_dir, "faces", "log_clustering.csv"),
                   "n_clusters,silhouette_score,calinski_harabasz_score,davies_bouldin_score",
                   [(k, s, c, d) for (k, _, s, c, d) in runs])

    if not spec.keep_all:
        best = max(runs, key=lambda r: r[2])
        runs = [best]
        print("The number of groups chosen: %u" % best[0])

    print("Grouped %u images into %s folders:"
          % (len(paths), "/".join(str(k) for (k, *_) in runs)))
    base = osp.dirname(osp.abspath(paths[0]))
    for k, labels, *_ in runs:
        sub = "G%u" % k if len(runs) > 1 else ""
        for j in range(k):
            os.makedirs(osp.join(base, sub, str(j)), exist_ok=True)
        for p, lbl in zip(paths, labels):
            skip_missing(shutil.copyfile, p, osp.join(base, sub, str(lbl), osp.basename(p)))
        _print_group_sizes(sub, labels)
    print()
    timer.report()
    for p in paths:
        skip_missing(os.remove, p)


def test_grouping(paths, refs, style, enc_model, device, out_dir, exclude_other,
                  encode_spec, other_thr, random_state):
    """Embedding-quality eval harness (reference grouping.py:140-155): prints
    classification accuracy vs labels.txt, rand score and silhouette for
    clustering at the ground-truth k."""
    gt, paths, n_clusters = get_ground_truths(paths, out_dir, exclude_other)
    model = get_encoder_model(style, enc_model, device)
    x = encode_faces(paths, model, encode_spec.batch_size, encode_spec.area)
    r = encode_refs(refs, model)

    assigned, _ = classify(x, r, [name for (name, _) in refs],
                           None if exclude_other else other_thr, True, paths, out_dir,
                           model.device)
    acc = np.count_nonzero(assigned + 1 == gt) / gt.size

    labels = kmeans_fit(x, n_clusters, random_state=random_state, device=model.device)[0]
    rand_scr = CS.rand_score(gt, labels)
    silh_scr = CS.silhouette_score(x, labels, n_clusters, device=model.device)

    print("%.4f / %.4f / %.4f" % (acc, rand_scr, silh_scr))
    print("classification accuracy / rand score for clustering / silhouette score for clustering")


def get_ground_truths(paths, out_dir, exclude_other):
    try:
        with open(osp.join(out_dir, "labels.txt")) as f:
            gt = np.asarray([int(v) for v in f.read().splitlines()])
    except Exception:
        raise ValueError("Could not load ground truth labels for testing."
                         "Expecting file \"labels.txt\" inside out_dir, "
                         "filled with line-separated integers")
    if exclude_other:
        other = gt.max()
        count = int(np.count_nonzero(gt == other))
        paths = [p for i, p in enumerate(paths) if gt[i] != other]
        gt = gt[gt != other]
        print('Excluded %u images with "other" class' % count)
    return gt, paths, int(gt.max())
