"""Detection pipeline: videos -> cropped face images on disk (counterpart of
videotofaces_tpu/pipeline/detection.py: one card, or the cards of the
detector's ``mesh``; in a multi-host job the final hash dedup is global,
parallel/multihost.py).

Behavioral contract (reference detection.py:32-162): per file, sample frames
on the step schedule, batch them through the detector, filter/adjust/square
the boxes, crop, name as ``[prefix][kk_]%06d_%u.jpg``, optionally resize,
drop near-duplicates against the previous 5 kept faces, write to
``out_dir/faces``; after all files, run the all-pairs hash dedup.

Decode is prefetched on a background thread, the detector runs batches on
the card with results copied back asynchronously (``submit``/``collect``),
and face writes go through an async writer pool. Stage wall-times go into a
StageTimer reported after each run, bound as the thread's recorder so that
the layers below add their own spans and counters (utils/profiling.py); set
V2F_PROFILE_DIR to also capture a ``torch.profiler`` trace.
"""

import os
import os.path as osp
from collections import deque

import numpy as np

from ..hostio import (AsyncImageWriter, ParallelFrameSource,
                      PrefetchingFrameSource, decode_workers_default,
                      open_reader)
from ..hostio.video import frame_schedule
from ..parallel import multihost as MH
from ..utils.image import resize_keep_ratio
from ..utils.pbar import tqdm
from ..utils.profiling import StageTimer, count, recording, span, trace
from . import boxfilter as BF
from .dupes import remove_dupes_nearest, remove_dupes_overall
from . import mesh_auto


def resolve_det_model(style, det_model):
    """The detector name ``det_model`` stands for ("default" picks per
    style: Faster R-CNN for anime, YOLO for live action)."""
    if det_model == "default":
        det_model = "rcnn" if style == "anime" else "yolo"
    if det_model not in ("yolo", "mtcnn", "rcnn"):
        raise ValueError("unknown det_model %r (valid: default, yolo, rcnn, mtcnn)"
                         % (det_model,))
    return det_model


def get_detector_model(style, det_model, device=None, mesh="auto", **model_kw):
    """String-dispatch model factory (reference detection.py:22-29): the
    YOLOv3, Faster R-CNN or MTCNN detector.

    ``mesh``: a ``parallel.Mesh`` shards inference over its devices;
    ``"auto"`` and None keep one device (pipeline/mesh_auto.py)."""
    from ..models.wrappers import FrcnnDetector, MtcnnDetector, YoloDetector

    factory = {"yolo": YoloDetector, "rcnn": FrcnnDetector,
               "mtcnn": MtcnnDetector}[resolve_det_model(style, det_model)]
    return factory(device, mesh=mesh_auto.resolve_mesh(mesh), **model_kw)


def detect_faces(files, model, sampling, criteria, layout, hash_thr,
                 collect_crops=False):
    """Run detection over every video in ``files``. Returns the saved face
    image paths — plus, with ``collect_crops``, a {filename: BGR array} dict
    of the surviving crops so grouping can encode straight from memory
    (``enc_from_memory``). ``sampling``/``criteria``/``layout`` are
    specs.FrameSampling / specs.BoxCriteria / specs.OutputLayout."""
    dedup_on = bool(hash_thr) and hash_thr != -1
    layout.prepare_dirs(dedup_on)
    if len(files) > 1:
        print("File count: " + str(len(files)))

    timer = StageTimer()
    names, hashes = [], []
    crops = {} if collect_crops else None
    with recording(timer), trace():
        for k, path in enumerate(files):
            print("Processing " + path)
            # multi-file runs get a per-file "01_", "02_", ... name prefix
            file_layout = layout if len(files) == 1 else \
                layout.with_prefix(layout.prefix + "%02d_" % (k + 1))
            n, h = process_video(path, model, sampling, criteria, file_layout,
                                 hash_thr, timer, crops)
            names += n
            hashes += h

        # multi-host jobs dedup GLOBALLY: gather every host's (hash, name)
        # rows, compute identical keep decisions everywhere, apply local
        # deletions only. Hosts with zero faces still join the gather.
        n_hosts = MH.process_info()[1]
        if dedup_on and (names or n_hosts > 1):
            with timer.stage("dedup:all-pairs", items=len(names)):
                # explicit uint64: np.stack on Python ints straddling 2^63
                # would promote to float64 and corrupt the low hash bits
                arr = np.asarray(hashes, dtype=np.uint64)
                if n_hosts > 1:
                    g_arr, g_names = MH.allgather_rows(arr, names)
                    if len(g_names):
                        # one hash per name (a host without faces gets the
                        # rows as one uint64 column)
                        g_arr = g_arr.reshape(len(g_names))
                        _, g_keep = remove_dupes_overall(g_arr, g_names, "hash",
                                                         hash_thr, layout, model.device)
                        local = set(names)
                        names = [n for n in g_keep if n in local]
                else:
                    _, names = remove_dupes_overall(arr, names, "hash", hash_thr, layout,
                                                    model.device)

    paths = [layout.face_path(fn) for fn in names]
    print()
    print("Saved a total of %u faces to: %s" % (len(paths), layout.faces_dir))
    print()
    timer.report()
    if collect_crops:
        keep = {osp.basename(fn) for fn in names}
        return paths, {k: v for k, v in crops.items() if k in keep}
    return paths


def process_video(path, model, sampling, criteria, layout, hash_thr, timer=None,
                  crops=None):
    """One video through the detector. Returns (face filenames, their hashes).
    Records into ``timer`` (a new ``StageTimer`` by default) the clip's
    edges, ``video:open`` and ``video:close``, and the decode workers'
    counters, ``decode:frames`` and ``decode:worker_us``."""
    timer = timer if timer is not None else StageTimer()
    with recording(timer):
        with span("video:open"):
            reader = open_reader(path, sampling.reader)
            if not reader.is_open():
                print("ERROR: could not open video: %s" % path)
                return [], []
            indices, step = frame_schedule(reader.length, reader.fps, sampling.step,
                                           sampling.fragment)
            workers = decode_workers_default()
            if workers > 1 and len(indices) > criteria.batch_size * workers:
                # multi-core host: segmented parallel decode (order-preserving)
                reader.close()
                source = ParallelFrameSource(path, indices, step, criteria.batch_size,
                                             sampling.area, sampling.reader, workers)
            else:
                source = PrefetchingFrameSource(reader, indices, step, criteria.batch_size,
                                                sampling.area)
        try:
            return process_stream(source, len(indices), model, criteria, layout,
                                  hash_thr, timer, crops)
        finally:
            # join the decode thread(s) BEFORE releasing the reader: a worker
            # may be mid-read, and cv2.VideoCapture is not safe against a
            # concurrent release; stop() also unblocks a worker stuck on the
            # prefetch queue
            with span("video:close"):
                if source.stop():
                    reader.close()
            count("decode:frames", source.tally.frames)
            count("decode:worker_us", source.tally.ns // 1000)


def process_stream(source, n_frames, model, criteria, layout, hash_thr, timer=None,
                   crops=None):
    """The detector loop over any (indices, frames) batch source, for a
    model with ``submit``/``collect``. Returns (face filenames, their
    hashes)."""
    timer = timer if timer is not None else StageTimer()
    with recording(timer):
        if getattr(model, "batch_size", False) is None:
            model.batch_size = criteria.batch_size  # one static batch shape per video

        names, hashes = [], []
        pbar = tqdm(total=n_frames)
        # In-flight queue depth: how many submitted batches ride ahead of the
        # collect point, so their results' copies back to the host overlap later
        # batches. Host memory held peaks at depth+1 batches of decoded frames.
        depth = max(1, int(os.environ.get("V2F_PIPELINE_DEPTH", "8")))
        inflight = deque()  # (handle, frames, indices) awaiting collect
        writer = AsyncImageWriter()

        def finish(inflight):
            handle, b_frames, b_idx = inflight
            with timer.stage("detect:collect", items=len(b_idx)):
                detout = model.collect(handle)
            with timer.stage("host:postprocess"):
                batch_names, new_hashes = process_frames_batch(
                    b_frames, b_idx, detout, criteria, layout, hash_thr,
                    hashes, writer, crops)
            names.extend(batch_names)
            pbar.update(len(b_idx))
            return new_hashes

        try:
            it = iter(source)
            while True:
                with timer.stage("decode:wait"):
                    nxt = next(it, None)
                if nxt is None:
                    break
                bi, frames = nxt
                with timer.stage("detect:submit", items=len(bi)):
                    handle = model.submit(frames)
                inflight.append((handle, frames, bi))
                if len(inflight) > depth:
                    hashes = finish(inflight.popleft())
            while inflight:
                hashes = finish(inflight.popleft())
        finally:
            with timer.stage("writer:join"):   # the last crops' JPEG writes
                writer.close()
        pbar.close()
        return names, [h for (h, _) in hashes]


def process_frames_batch(frames, indices, detout, criteria, layout, hash_thr,
                         hashes, writer, crops=None):
    """Host post-processing for one batch. ``detout`` is the detector output:
    a (boxes, scores, classes) tuple of per-frame lists (YOLO, Faster
    R-CNN), or a list of [n, 5] (x1, y1, x2, y2, score) arrays, one per
    frame (MTCNN)."""
    img_size = frames[0].shape[:2]
    if isinstance(detout, tuple):
        boxes_list, scores_list = detout[0], detout[1]
    else:
        boxes_list = [d[:, :4] for d in detout]
        scores_list = [d[:, 4] for d in detout]

    faces = []
    for frame, frame_idx, raw_boxes, raw_scores in zip(frames, indices, boxes_list, scores_list):
        # round to ints and apply the three rejection conditions
        iboxes = BF.round_out(raw_boxes)
        scores = np.asarray(raw_scores)
        c1, c2, c3 = BF.check_conditions(iboxes, scores, img_size, criteria.min_score,
                                         criteria.min_size, criteria.min_border)
        rejected = c1 | c2 | c3
        if layout.save_frames:
            BF.render_debug_frame(
                frame, iboxes, scores, rejected,
                layout.intermediate("frames", layout.prefix + "%06d.jpg" % frame_idx))
        if layout.save_rejects:
            BF.save_rejects_and_log(frame, frame_idx, iboxes, scores, c1, c2, c3,
                                    layout.root, layout.prefix, criteria.min_score,
                                    criteria.min_size, criteria.min_border)
        passed = iboxes[~rejected]
        # scale/square the survivors
        adjusted = BF.adjust_boxes(passed, img_size, criteria.scale, criteria.square)
        # crop and name as %06d_%u.jpg (skip crops that fall fully outside
        # the frame — only possible with degenerate detector outputs)
        for j, (x1, y1, x2, y2) in enumerate(adjusted):
            crop = frame[y1:y2, x1:x2]
            if crop.size == 0:
                continue
            faces.append((crop, layout.prefix + "%06d_%u.jpg" % (frame_idx, j)))

    # optional thumbnailing
    if layout.resize_to:
        faces = [(resize_keep_ratio(img, layout.resize_to), fn) for (img, fn) in faces]
    # previous-5 hash dedup
    if hash_thr and hash_thr != -1:
        faces, hashes = remove_dupes_nearest(faces, hashes, hash_thr, layout)
    # async writes (and the optional in-memory copy for enc_from_memory)
    for img, fn in faces:
        if crops is not None:
            crops[fn] = img
        writer.write(layout.face_path(fn), img)
    return [fn for (_, fn) in faces], hashes
