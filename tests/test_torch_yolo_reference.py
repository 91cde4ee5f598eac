"""YOLOv3 against the benchmark's plain reference (``portbench/reference/
yolo.py``) on the CPU: one state drawn from a seed (``portbench.seeding``)
and calibrated as the benchmark calibrates it (``portbench/detectors/
yolov3.py::calibrate``) is loaded into the program's ``YoloDetector`` and
into the reference, which then see the same frames. Also the detector's
``yolo:*`` spans and its ``yolo:candidates`` counter.

The file imports neither JAX nor the JAX package."""

import tempfile

import numpy as np
import pytest
import torch

from portbench import judge, models, registry, seeding, traffic
from portbench.reference import pipeline as RP
from portbench.reference import yolo as RY
from videotofaces_tpu_torch.models import yolo as TY
from videotofaces_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

CELL = "live_yolov3_facenet.video"
# Head maps: the same float32 convolutions in the same order on the same
# inputs; the bound leaves room for a CPU library that blocks a
# convolution's sums differently for two modules (75 convolutions deep,
# maps of magnitude up to ~10 after the calibration's gain).
MAPS_TOL = dict(rtol=1e-5, atol=1e-4)


def _frames(w, h, n=4, seed=5):
    spec = dict(clips=1, size=[w, h], fps=4, seconds=n / 4 + 0.5, faces=3, face_px=[20, 60],
                variants=2, noise=3, quality=90, threads=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = traffic.make_clips(tmp, seed, spec)[0]
        return RP.read_frames(path, 0.25)[1][:n]


def _cfg(per_frame):
    """The cell's configuration at a 160 px ``max_side`` with the box rules
    of the harness's tiny runs, ``per_frame`` candidates a frame."""
    cfg = registry.config("live_yolov3_facenet")
    d = cfg["detector"]
    d["max_side"] = 160
    (spec,) = d["calibrate"]
    spec.update(per_frame=per_frame, kept_per_frame=1, criteria={"min_size": 8, "min_border": 1})
    return cfg


def _both(cfg, frames, seed=2999999937):
    cpu = torch.device("cpu")
    state, calibration = models.detector_state(cfg, seed, cpu, frames)
    det = models.program_detector(cfg, state, cpu)
    ref = models.reference_detector(cfg).eval()
    seeding.load_state_(ref, state)
    return det, ref, calibration


# (frame w, h) -> canvas: 320 x 180 -> 96 x 160 (D = 945), 160 x 120 ->
# 128 x 160 (D = 1,260); 1,200 candidates a frame fill the 1,000-slot cap
@pytest.mark.parametrize("size, canvas, per_frame", [
    ((320, 180), (96, 160), 100), ((160, 120), (128, 160), 100),
    ((160, 120), (128, 160), 1200)], ids=["96x160", "128x160", "128x160-at-cap"])
def test_detector_matches_the_plain_reference(size, canvas, per_frame):
    frames = _frames(*size)
    cfg = _cfg(per_frame)
    det, ref, calibration = _both(cfg, frames)
    resized = TY.resized_shape(size[1], size[0], 160)
    assert TY.canvas_shape(*resized) == canvas == RY.canvas_shape(*resized)
    x = torch.from_numpy(np.stack(frames))
    with torch.no_grad():
        got = det.model(TY.preprocess(x, resized, canvas))
        want = ref(RY.preprocess(x, resized, canvas))
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, **MAPS_TOL)

    priors, strides = (torch.from_numpy(a) for a in TY.flat_priors_and_strides(canvas))
    with torch.no_grad():
        program = TY.full_forward(det.model, x, resized, canvas, priors, strides)
        reference = RY.full_forward(ref, x, 160)
    cap = cfg["detector"]["pre_topk"]
    assert program[5].tolist() == reference[4].tolist()
    if per_frame > cap:
        assert program[5].tolist() == [cap] * len(frames)
    else:
        assert max(program[5].tolist()) < cap

    det.batch_size = len(frames)
    boxes, scores, _ = det(frames)
    want = models.reference_detect(cfg, ref, frames, len(frames))
    assert sum(len(s) for _, s in want) > 0
    values, _ = judge.detections(list(zip(boxes, scores)), want,
                                 cfg["detector"]["calibrate"][0]["threshold"])
    limits = registry.limits(CELL)["numbers"]
    assert values["unmatched"] == 0, values
    for k in ("score_gap_max", "box_gap_max", "pass_score_gap_max", "pass_box_gap_max"):
        assert values[k] <= limits[k]["limit"], (k, values)
    assert calibration["head.pred"]["kept_per_frame"] > 0


def test_spans_and_the_candidate_counter():
    """One submit and collect of 3 frames in a batch of 4 (the last frame
    repeated) under a bound recorder: ``yolo:body``, ``yolo:select`` and
    ``yolo:nms`` once each, ``nms:fixpoint`` inside ``yolo:nms``, and the
    ``yolo:candidates`` counter equal to the valid slots that
    ``select_candidates`` returns for the 3 real frames."""
    frames = _frames(320, 180, n=3)
    cfg = _cfg(100)
    det, _, _ = _both(cfg, frames)
    det.batch_size = 4
    timer = P.StageTimer()
    with P.recording(timer):
        det.collect(det.submit(frames))
    assert [timer.calls[n] for n in ("yolo:body", "yolo:select", "yolo:nms")] == [1, 1, 1]
    iv = timer.intervals
    for name, _, _, parent in iv:
        if name == "nms:fixpoint":
            assert iv[parent][0] == "yolo:nms"
    resized = TY.resized_shape(180, 320, 160)
    canvas = TY.canvas_shape(*resized)
    x = torch.from_numpy(np.stack(frames + frames[-1:]))
    with torch.no_grad():
        vals, _, _ = TY.select_candidates(det.model(TY.preprocess(x, resized, canvas)))
    want = int((vals[:3] > 0).sum())
    assert want > 0 and timer.calls["yolo:candidates"] == 1
    assert timer.items["yolo:candidates"] == want
