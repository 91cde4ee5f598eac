"""``video_to_faces`` — the single public entry point (counterpart of
videotofaces_tpu/api.py).

The same 27 keyword arguments with the same defaults as the JAX package and
the reference orchestrator (main.py:13-82). ``device`` is real here: None
means the CUDA card (and raises without one), ``"cpu"`` runs the plain
versions of the kernels on the CPU.

This slice of the port runs ``mode="detection"`` with ``det_model="mtcnn"``.
Grouping (``mode="full"`` / ``"grouping"``) and the YOLO / Faster R-CNN
detectors raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.
"""

import os.path as osp

from . import config, prep
from .pipeline.detection import (detect_faces, get_detector_model,
                                 resolve_det_model)
from .specs import BoxCriteria, FrameSampling, OutputLayout

_GROUPING_ITEM = "queue 1, item 6 (FaceNet and grouping)"


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
    if mode != 'detection' or _test_enc:
        raise NotImplementedError(
            "mode=%r is not ported to videotofaces_tpu_torch yet (ROADMAP.md %s); "
            "this slice runs mode='detection'" % (mode, _GROUPING_ITEM))
    det_model = resolve_det_model(style, det_model)
    device = config.resolve_device(device)
    if not out_dir:
        out_dir = (input_path if osp.isdir(input_path)
                   else osp.dirname(osp.abspath(input_path)))

    layout = OutputLayout(root=out_dir, prefix=out_prefix, resize_to=resize_to,
                          save_frames=save_frames, save_rejects=save_rejects,
                          save_dupes=save_dupes)
    sampling = FrameSampling(step=video_step, fragment=video_fragment,
                             area=video_area, reader=video_reader)
    criteria = BoxCriteria(batch_size=det_batch_size, min_score=det_min_score,
                           min_size=det_min_size, min_border=det_min_border,
                           scale=det_scale, square=det_square)
    videos = prep.get_video_list(input_path, input_ext)
    if not videos:
        return
    detector = get_detector_model(style, det_model, device)
    detect_faces(videos, detector, sampling, criteria, layout, hash_thr)
    print('Done')
