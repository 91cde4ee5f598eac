"""The port's recorder (``utils/profiling.py``) and the spans and counters
the pipeline, the detectors, the NMS and the decode sources put into it.

The file imports neither JAX nor the JAX package; its one ``cuda`` test
runs on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import threading
import tracemalloc
import warnings

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu_torch import specs
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.models.wrappers import FrcnnDetector, MtcnnDetector, YoloDetector
from videotofaces_tpu_torch.pipeline.detection import process_video
from videotofaces_tpu_torch.utils import profiling as P

# every span and counter the pipeline records into the bound recorder of
# one clip, by detector (the stage spans are each model's own)
PIPELINE = {"video:open", "video:close", "writer:join", "decode:frames", "decode:worker_us",
            "decode:ahead", "decode:wait", "detect:submit", "detect:collect", "host:postprocess",
            "detect:h2d", "detect:d2h", "detect:wait", "nms:fixpoint", "host:sync"}
STAGES = {"mtcnn": {"mtcnn:stage1", "mtcnn:stage2", "mtcnn:stage3"},
          "rcnn": {"rcnn:body", "rcnn:rpn", "rcnn:roi"},
          "yolo": {"yolo:body", "yolo:select", "yolo:nms"}}
# the counters a detector records in ``collect``, once its batch has landed
LANDED = {"mtcnn": set(), "rcnn": set(), "yolo": {"yolo:candidates"}}


def _detector(kind):
    if kind == "mtcnn":
        return MtcnnDetector("cpu", min_face_size=12, batch_size=2)
    if kind == "yolo":
        return YoloDetector("cpu", batch_size=2, max_side=96)
    return FrcnnDetector("cpu", batch_size=2, resize_spec=(64, 96), proposal_cap=64,
                         out_top=16)


def _write_clip(path, n_frames=24, fps=10, size=(160, 120), seed=0):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    assert vw.isOpened()
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
        frame[20:60, 30 + i:70 + i] = (200, 170, 150)
        vw.write(frame)
    vw.release()


def _run_clip(tmp_path, model, step=0.3, batch_size=2, timer=None, **clip):
    video = str(tmp_path / "clip.avi")
    _write_clip(video, **clip)
    layout = specs.OutputLayout(root=str(tmp_path / "out"))
    layout.prepare_dirs(True)
    timer = timer if timer is not None else P.StageTimer()
    process_video(video, model, specs.FrameSampling(step=step),
                  specs.BoxCriteria(batch_size=batch_size), layout, 8, timer)
    return timer


class _Clock:
    """A stand-in for ``time`` whose ``time_ns`` steps by 10 on each call."""

    def __init__(self):
        self.t = 0

    def time_ns(self):
        self.t += 10
        return self.t


def test_recording_binds_per_thread_and_nests():
    assert P.span("a") is P.span("b")          # no recorder: one shared no-op
    P.count("n", 3)
    outer, inner = P.StageTimer(), P.StageTimer()
    with P.recording(outer):
        with P.span("a", 2):
            with P.recording(inner):
                with P.span("b"):
                    P.count("n", 5)
            with P.span("c"):
                pass
    assert P.span("a") is P.span("b")
    assert dict(outer.calls) == {"a": 1, "c": 1} and outer.items["a"] == 2
    assert dict(inner.calls) == {"b": 1, "n": 1} and inner.items["n"] == 5
    assert [(n, p) for n, _, _, p in outer.intervals] == [("a", -1), ("c", 0)]
    assert [(n, p) for n, _, _, p in inner.intervals] == [("b", -1), ("n", 0)]


def test_a_span_on_another_thread_is_not_recorded():
    main, other = P.StageTimer(), P.StageTimer()

    def work():
        with P.span("unbound"):
            pass
        with P.recording(other), P.span("own"):
            pass

    with P.recording(main):
        with P.span("here"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    assert dict(main.calls) == {"here": 1}
    assert dict(other.calls) == {"own": 1}


def test_stage_timer_keeps_parents_and_self_time(monkeypatch):
    monkeypatch.setattr(P, "time", _Clock())
    timer = P.StageTimer()
    with timer.stage("outer"):
        with timer.stage("inner", 3):
            with timer.stage("leaf"):
                pass
        with timer.stage("inner"):
            pass
    iv = timer.intervals
    assert [(n, p) for n, _, _, p in iv] == [("outer", -1), ("inner", 0), ("leaf", 1),
                                              ("inner", 0)]
    assert all(t1 > t0 for _, t0, t1, _ in iv)
    dur = {k: (t1 - t0) / 1e9 for k, (_, t0, t1, _) in enumerate(iv)}
    assert timer.total["outer"] == pytest.approx(dur[0])
    assert timer.self_total["outer"] == pytest.approx(dur[0] - dur[1] - dur[3])
    assert timer.self_total["inner"] == pytest.approx(dur[1] - dur[2] + dur[3])
    assert timer.self_total["leaf"] == timer.total["leaf"]
    assert timer.calls["inner"] == 2 and timer.items["inner"] == 3
    text = timer.summary()
    assert "outer: " in text and ", self " in text and "(2 calls, 3 items" in text


def test_an_unbound_span_allocates_nothing():
    def loop(n):
        for _ in range(n):
            with P.span("x", 1):
                pass
            P.count("y", 1)

    loop(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        loop(2000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename.endswith(
                 ("profiling.py", "contextlib.py"))]
    assert not grown, grown


def test_trace_names_the_spans_on_its_timeline(tmp_path):
    timer = P.StageTimer()
    with P.recording(timer), P.trace(str(tmp_path)):
        with P.span("v2f_traced"):
            (torch.ones(8) * 2).sum()
    written = list(tmp_path.glob("trace_*.json"))
    assert len(written) == 1 and "v2f_traced" in written[0].read_text()
    assert timer.calls["v2f_traced"] == 1
    assert P._traces == 0 and P.span("a") is P.span("b")


@pytest.mark.parametrize("kind", ["mtcnn", "rcnn", "yolo"])
def test_process_video_records_every_span(tmp_path, monkeypatch, kind):
    """One clip through a CPU detector: every span and counter of the
    pipeline and the detector lands in the recorder, under its parent; the
    ``host:sync`` spans are the fixpoints' convergence checks and MTCNN's
    bucket checks (a CPU run copies no constant to a device)."""
    checks = {"equal": 0, "bucket": 0}
    equal = torch.equal

    def counted_equal(a, b):
        checks["equal"] += 1
        return equal(a, b)

    bucketed = TM.nms_keep_mask_bucketed

    def counted_bucketed(boxes, scores, valid, thr, bucket=256, **kw):
        checks["bucket"] += scores.shape[1] > bucket
        return bucketed(boxes, scores, valid, thr, bucket, **kw)

    monkeypatch.setattr(torch, "equal", counted_equal)
    monkeypatch.setattr(TM, "nms_keep_mask_bucketed", counted_bucketed)
    timer = _run_clip(tmp_path, _detector(kind))
    names = set(timer.calls)
    want = PIPELINE | STAGES[kind] | LANDED[kind]
    assert want <= names, want - names
    assert timer.calls["host:sync"] == timer.items["host:sync"] == \
        checks["equal"] + checks["bucket"]
    assert checks["equal"] >= timer.calls["nms:fixpoint"] > 0
    assert (checks["bucket"] > 0) == (kind == "mtcnn")
    iv = timer.intervals
    parent = {k: iv[p][0] if p >= 0 else None for k, (_, _, _, p) in enumerate(iv)}
    for k, (name, _, _, _) in enumerate(iv):
        if name in STAGES[kind] or name in ("detect:h2d", "detect:d2h"):
            assert parent[k] == "detect:submit", (name, parent[k])
        elif name == "detect:wait" or name in LANDED[kind]:
            assert parent[k] == "detect:collect", (name, parent[k])
        elif name == "nms:fixpoint":
            assert parent[k] in STAGES[kind], parent[k]
        elif name == "host:sync":
            assert parent[k] in STAGES[kind] | {"nms:fixpoint"}, parent[k]
        elif name in ("video:open", "video:close", "writer:join", "decode:frames"):
            assert parent[k] is None, (name, parent[k])
    assert timer.total["detect:submit"] >= sum(
        timer.total[n] for n in STAGES[kind] | {"detect:h2d", "detect:d2h"})


@pytest.mark.parametrize("kind", ["mtcnn", "rcnn", "yolo"])
def test_detections_are_the_same_with_a_recorder_bound(kind):
    det = _detector(kind)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (120, 160, 3), dtype=np.uint8) for _ in range(2)]
    frames[0][20:70, 40:90] = (210, 180, 160)
    free = det(frames)
    timer = P.StageTimer()
    with P.recording(timer):
        bound = det(frames)
    assert timer.calls["detect:h2d"] == 1 and timer.calls["nms:fixpoint"] > 0
    flat = lambda out: [np.asarray(a) for part in (out if isinstance(out, tuple) else (out,))
                        for a in part]
    for a, b in zip(flat(free), flat(bound), strict=True):
        np.testing.assert_array_equal(a, b)


class _NoFaces:
    """A detector that finds nothing, for the decode counters alone."""

    batch_size = None
    device = torch.device("cpu")

    def submit(self, frames):
        return len(frames)

    def collect(self, n):
        return [np.zeros((0, 5), np.float32)] * n


@pytest.mark.parametrize("workers", [1, 3])
def test_decode_counts_the_frames_grabbed(tmp_path, monkeypatch, workers):
    """A 10 fps MJPG clip sampled every 0.3 s (a step of 3 frames): each
    reader grabs from its start to its last sampled frame, and
    ``decode:frames`` is the sum, as a capture that counts its grabs and
    reads sees it."""
    real = cv2.VideoCapture
    seen = []

    class Counting:
        def __init__(self, path):
            self.cap = real(path)

        def grab(self):
            seen.append(1)
            return self.cap.grab()

        def read(self):
            seen.append(1)
            return self.cap.read()

        def __getattr__(self, name):
            return getattr(self.cap, name)

    monkeypatch.setattr(cv2, "VideoCapture", Counting)
    monkeypatch.setenv("V2F_DECODE_WORKERS", str(workers))
    timer = _run_clip(tmp_path, _NoFaces(), n_frames=64, size=(64, 48))
    indices = list(range(3, 64, 3))
    batches = [indices[i:i + 2] for i in range(0, len(indices), 2)]
    if workers == 1:
        want = indices[-1] + 1                   # one reader from frame 0
    else:
        seg = -(-len(batches) // workers)        # each segment seeks to its head
        want = sum(s[-1][-1] - s[0][0] + 1
                   for s in (batches[j * seg:(j + 1) * seg] for j in range(workers)) if s)
    assert timer.items["decode:frames"] == len(seen) == want
    assert timer.calls["decode:frames"] == timer.calls["decode:worker_us"] == 1
    assert timer.items["decode:worker_us"] > 0
    assert timer.items["detect:submit"] == len(indices)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mtcnn", "rcnn", "yolo"])
def test_every_sync_of_a_submit_is_a_host_sync_span(kind):
    """Under ``torch.cuda.set_sync_debug_mode("warn")``, each call of one
    ``submit`` that blocks the host on the card warns; each warning falls
    inside an open ``host:sync`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    class Open:
        def __init__(self):
            self.stack = []

        def stage(self, name, items=0):
            rec = self

            class _Ctx:
                def __enter__(self):
                    rec.stack.append(name)

                def __exit__(self, *exc):
                    rec.stack.pop()

            return _Ctx()

    det = {"mtcnn": lambda: MtcnnDetector("cuda", min_face_size=5, batch_size=2),
           "rcnn": lambda: FrcnnDetector("cuda", batch_size=2),
           "yolo": lambda: YoloDetector("cuda", batch_size=2)}[kind]()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (1080, 1920, 3), dtype=np.uint8) for _ in range(2)]
    det.collect(det.submit(frames))              # build, warm up, fill the caches
    torch.cuda.synchronize()
    rec, syncs, outside = Open(), [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            syncs.append(filename)
            if "host:sync" not in rec.stack:
                outside.append("%s:%d %s" % (filename, lineno, list(rec.stack)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with P.recording(rec):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handle = det.submit(frames)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    det.collect(handle)
    assert syncs and not outside, outside
