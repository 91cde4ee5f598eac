"""``video_to_faces`` — the single public entry point (counterpart of
videotofaces_tpu/api.py).

The same 27 keyword arguments with the same defaults as the JAX package and
the reference orchestrator (main.py:13-82), the same three modes (``full``
/ ``detection`` / ``grouping``) and the same on-disk output layout. Stage
parameters travel as typed spec objects (specs.py), and each stage is a
small private runner. ``device`` is real here: None means the CUDA card
(and raises without one), ``"cpu"`` runs the plain versions of the kernels
on the CPU.

The port runs the YOLOv3, Faster R-CNN and MTCNN detectors and the ViT and
FaceNet encoders, so both styles run with their defaults (``style="anime"``:
Faster R-CNN + ViT-B16; ``style="live"``: YOLOv3 + FaceNet-VGG).

Where the JAX package shards over every device of the host by default
(``mesh="auto"``; V2F_SINGLE_DEVICE=1 opts out), this entry point runs on
one card: the port's ``mesh="auto"`` keeps one device until a sharded call
beats one card (pipeline/mesh_auto.py). The model factories,
``FaceService`` and the grouping ops shard over a ``parallel.Mesh`` passed
to them.

Multi-host jobs (parallel/multihost.py): launched as one process per host
with ``V2F_PROCESS_INDEX`` / ``V2F_PROCESS_COUNT`` and a gather directory
(``V2F_GATHER_DIR`` + ``V2F_RUN_ID``), or under a ``torch.distributed``
process group that the launching script initialized, each host detects
its round-robin shard of the videos (or, in grouping mode, of the face
images of a shared ``out_dir``), names its faces ``hNN_...``, and joins
the global hash dedup, embedding dedup and grouping, which every host
computes identically from the gathered rows.
"""

import os.path as osp
from typing import NamedTuple, Optional

import numpy as np

from . import config, prep
from .parallel import multihost as MH
from .pipeline.detection import detect_faces, get_detector_model, resolve_det_model
from .pipeline.dupes import remove_dupes_overall
from .pipeline.grouping import (classify_faces, cluster_faces, encode_faces,
                                get_encoder_model, resolve_enc_model, test_grouping)
from .specs import (BoxCriteria, ClassifySpec, ClusterSpec, EncodeSpec,
                    FrameSampling, OutputLayout)


class _GroupingPlan(NamedTuple):
    """Inputs the grouping stage needs, resolved up front so a bad spec fails
    before any model loads."""

    clusters: Optional[list]     # candidate k values (clustering / eval)
    refs: Optional[list]         # [(class, [paths])] (classification / eval)
    paths: Optional[list]        # pre-existing face images (grouping mode)


def _plan_grouping(mode, group_mode, clusters, ref_dir, out_dir, want_eval):
    """Returns a _GroupingPlan, or None when a required input is unavailable
    (the error was already printed, reference-style)."""
    ks = refs = paths = None
    if group_mode == "clustering" or want_eval:
        ks = prep.get_clusters(clusters)
        if not ks:
            return None
    if group_mode == "classification" or want_eval:
        refs = prep.get_class_ref(ref_dir, out_dir)
        if not refs:
            return None
    if mode == "grouping":
        paths = prep.get_paths_for_grouping(out_dir)
        if not paths:
            return None
        # multi-host grouping-only: each host encodes a disjoint shard, like
        # detection shards videos — without this, every host would gather H
        # identical copies of every row and the global dedup would mark the
        # duplicates (distance 0) for deletion, destroying the face set.
        # Round-robin sharding is disjoint-and-complete ONLY if every host
        # lists the identical directory (shared filesystem); with host-local
        # out_dirs most faces would silently never be encoded. Verify by
        # all-gathering the name lists before sharding.
        index, count = MH.process_info()
        if count > 1:
            names = [osp.basename(p) for p in paths]
            _, gathered = MH.allgather_rows(
                np.zeros((len(names), 1), np.uint8), names)
            if sorted(gathered) != sorted(names * count):
                raise RuntimeError(
                    "grouping-only multi-host requires every host to see the "
                    "same out_dir listing (shared filesystem): host %d lists "
                    "%d faces but the %d hosts' listings differ" %
                    (index, len(names), count))
        paths = MH.shard_list(paths)
    return _GroupingPlan(ks, refs, paths)


def _run_detection(input_path, input_ext, style, det_model, device,
                   sampling, criteria, layout, hash_thr, collect_crops=False):
    """Detection stage: videos -> face crops on disk. Returns (paths, crops)
    where crops is the in-memory {name: array} dict (``enc_from_memory``) or
    None; paths is None when no input videos were found."""
    videos = prep.get_video_list(input_path, input_ext)
    if not videos:
        return None, None
    # multi-host job: each host detects its own shard of the library
    # (parallel/multihost.py); dedup inside detect_faces goes global
    videos = MH.shard_list(videos)
    detector = get_detector_model(style, det_model, device)
    out = detect_faces(videos, detector, sampling, criteria, layout, hash_thr,
                       collect_crops=collect_crops)
    return out if collect_crops else (out, None)


def _run_grouping(paths, plan, style, enc_model, device, group_mode,
                  encode_spec, cluster_spec, classify_spec, layout, crops=None):
    """Grouping stage: face crops -> embeddings -> folders per person."""
    encoder = get_encoder_model(style, enc_model, device)
    features = encode_faces(paths, encoder, encode_spec.batch_size,
                            encode_spec.area, images=crops)
    if MH.process_info()[1] > 1:
        # go global: every host gathers all (embedding, name) rows, computes
        # identical dedup/cluster decisions, and moves only its local files
        names = [osp.basename(p) for p in paths]
        features, g_names = MH.allgather_rows(
            np.asarray(features, np.float32), names)
        paths = [layout.face_path(n) for n in g_names]
    thr = encode_spec.dup_thr
    if thr and thr != -1:
        features, paths = remove_dupes_overall(features, paths, "enc", thr, layout,
                                               device)
    if not len(paths):
        print("No faces to group")
        return
    if group_mode == "clustering":
        cluster_faces(paths, features, cluster_spec, layout.root, device)
    if group_mode == "classification":
        classify_faces(paths, features, encoder, classify_spec, layout.root)


def video_to_faces(input_path=None, input_ext=None,
                   mode='full', style='anime', device=None,
                   out_dir=None, out_prefix='', resize_to=None,
                   save_frames=False, save_rejects=False, save_dupes=False,
                   video_step=1, video_fragment=None, video_area=None, video_reader='opencv',
                   det_model='default', det_batch_size=4, det_min_score=0.4, det_min_size=50,
                   det_min_border=5, det_scale=(1.5, 1.5, 2.2, 1.2), det_square=True,
                   hash_thr=8,
                   enc_model='default', enc_batch_size=16, enc_area=None,
                   group_mode='clustering', clusters=None, clusters_save_all=False,
                   ref_dir=None, random_state=0, group_log=True,
                   enc_dup_thr=0.25, enc_oth_thr=0.9,
                   enc_from_memory=False,
                   _test_enc=False, _test_exclude_other=False):

    if not prep.validate_args(mode, input_path, out_dir, style, group_mode,
                              video_reader, det_model, enc_model):
        return

    detecting = mode in ('full', 'detection')
    grouping = mode in ('full', 'grouping')
    # resolve the model names before anything runs
    if detecting:
        det_model = resolve_det_model(style, det_model)
    if grouping:
        enc_model = resolve_enc_model(style, enc_model)
    device = config.resolve_device(device)
    if not out_dir:
        out_dir = (input_path if osp.isdir(input_path)
                   else osp.dirname(osp.abspath(input_path)))

    plan = None
    if grouping:
        plan = _plan_grouping(mode, group_mode, clusters, ref_dir, out_dir, _test_enc)
        if plan is None:
            return

    # multi-host: face names carry a host tag so the global namespace is
    # collision-free (parallel/multihost.host_prefix is identity single-host)
    layout = OutputLayout(root=out_dir, prefix=MH.host_prefix(out_prefix),
                          resize_to=resize_to,
                          save_frames=save_frames, save_rejects=save_rejects,
                          save_dupes=save_dupes)

    faces = plan.paths if plan else None
    crops = None
    if detecting:
        sampling = FrameSampling(step=video_step, fragment=video_fragment,
                                 area=video_area, reader=video_reader)
        criteria = BoxCriteria(batch_size=det_batch_size, min_score=det_min_score,
                               min_size=det_min_size, min_border=det_min_border,
                               scale=det_scale, square=det_square)
        faces, crops = _run_detection(
            input_path, input_ext, style, det_model, device, sampling, criteria,
            layout, hash_thr, collect_crops=enc_from_memory and grouping)
        if faces is None:
            return

    # a host whose shard yielded no faces must still join the global gathers
    # of a multi-host job, or its peers would block in allgather_rows
    if grouping and faces is not None and (faces or MH.process_info()[1] > 1):
        encode_spec = EncodeSpec(enc_batch_size, enc_area, enc_dup_thr)
        if _test_enc:
            test_grouping(faces, plan.refs, style, enc_model, device, out_dir,
                          _test_exclude_other, encode_spec, enc_oth_thr, random_state)
            return
        _run_grouping(
            faces, plan, style, enc_model, device, group_mode, encode_spec,
            ClusterSpec(plan.clusters, clusters_save_all, random_state, group_log),
            ClassifySpec(plan.refs or (), enc_oth_thr, group_log),
            layout, crops=crops)

    print('Done')
