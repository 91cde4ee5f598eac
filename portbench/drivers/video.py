"""The ``video`` mix: folders of clips through the detection pipeline,
``pipeline.detection.process_video`` one clip after another (decode on the
pipeline's worker threads, the detector's submit / collect queue, box
filter, crops, the window hash dedup, JPEG writes).

End to end: ``frames_per_s``, every sampled frame of the clips run in the
window over the window (which ends with the clip that was running at the
deadline). ``correct``: one pass of the window over the clips, drawn from
the seed (the first in a traced run), is decoded again by the reference,
which detects, crops and dedups on its own; the program's detections
(taken as ``collect`` returns them) and kept crops (``process_video``'s
``crops=``) are compared with the reference's: the largest score and box
gaps of the matched detections, of all and of those that pass the box
rules' score cut, the detections left unmatched and the kept crops that
differ, as counts."""

import json
import os.path as osp
import shutil
import sys
import time

import numpy as np
import torch

from .. import judge, models, precision, registry, seeding, traffic
from ..reference import pipeline as RP
from ..spans import SpanRecorder


class RecordingDetector:
    """The program's detector as ``process_stream`` sees it; counts the
    frames that come back from ``collect``, keeps each batch's stage counts
    where the detector's module reads them (``stage_counts``) and, while
    ``records`` is a list, each frame's (boxes, scores)."""

    def __init__(self, det, stage_counts=None):
        self.det = det
        self.read_counts = stage_counts
        self.frames = 0
        self.batches = 0
        self.records = None
        self.stage_counts = []

    @property
    def batch_size(self):
        return self.det.batch_size

    @batch_size.setter
    def batch_size(self, v):
        self.det.batch_size = v

    @property
    def device(self):
        return self.det.device

    def submit(self, frames):
        return self.det.submit(frames)

    def collect(self, handle):
        out = self.det.collect(handle)
        if isinstance(out, tuple):
            per_frame = list(zip(out[0], out[1]))
        else:
            per_frame = [(d[:, :4], d[:, 4]) for d in out]
        counts = self.read_counts(handle) if self.read_counts else None
        if counts is not None:
            n = len(per_frame)
            self.stage_counts.append({k: v[:n].copy() for k, v in counts.items()})
        self.frames += len(per_frame)
        self.batches += 1
        if self.records is not None:
            self.records += [(np.array(b, np.float32), np.array(s, np.float32))
                             for b, s in per_frame]
        return out


def _specs(run):
    from videotofaces_tpu_torch import specs

    tr = run.traffic
    sampling = specs.FrameSampling(step=tr["video_step"])
    criteria = specs.BoxCriteria(batch_size=tr["batch_size"], **tr["criteria"])
    return sampling, criteria


def device_of(run):
    return torch.device(run.state.get("device", "cuda"))


def setup(run):
    from videotofaces_tpu_torch import config as V2F

    cfg, tr = run.config, run.traffic
    dev = device_of(run)
    V2F.set_precision(cfg["precision"])
    # the benchmark's own preparation: the clips made from the seed and the
    # heads calibrated by the reference (left out of setup_s)
    t0 = time.perf_counter()
    run.state["clips"] = traffic.make_clips(osp.join(run.scratch, "clips"), run.seed, tr["clip"])
    calib = RP.spread_frames(run.state["clips"], tr["video_step"],
                             cfg["detector"]["calibration_frames"])
    run.state["det_state"], calibration = models.detector_state(cfg, run.seed, dev, calib)
    run.prep_s = time.perf_counter() - t0
    print("portbench: calibration %s" % json.dumps(calibration), file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    det = RecordingDetector(models.program_detector(cfg, run.state["det_state"], dev),
                            getattr(models.detector(cfg), "stage_counts", None))
    run.state["det"] = det
    run.state["specs"] = _specs(run)
    # warm-up: the first clip through the pipeline, every batch shape of
    # the window
    _clip(run, run.state["clips"][0], osp.join(run.scratch, "warm"), SpanRecorder(), {})
    det.frames = det.batches = 0
    det.stage_counts = []


def _clip(run, path, root, timer, crops):
    from videotofaces_tpu_torch import specs
    from videotofaces_tpu_torch.pipeline.detection import process_video

    sampling, criteria = run.state["specs"]
    layout = specs.OutputLayout(root=root)
    layout.prepare_dirs(True)
    return process_video(path, run.state["det"], sampling, criteria, layout,
                         run.traffic["hash_thr"], timer, crops)


def window(run):
    det, clips = run.state["det"], run.state["clips"]
    # a traced run checks the first pass over the clips: the kernels' work
    # is counted from the reference's inputs of the same batches (``work``)
    check_pass = 0 if run.traced else int(
        np.random.default_rng(run.seed).integers(0, run.traffic["check_among"]))
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    k = 0
    checked = {}
    while True:
        c = k % len(clips)
        crops = {}
        det.records = []
        with run.spans.stage("harness:clip"):
            _clip(run, clips[c], osp.join(run.scratch, "out%d" % c), run.spans, crops)
        if k // len(clips) <= check_pass:
            checked[c] = {"clip": clips[c], "run": k, "detections": det.records, "crops": crops}
        det.records = None
        k += 1
        if time.perf_counter() >= deadline:
            break
    elapsed = time.perf_counter() - t0
    run.state["checked"] = [checked[c] for c in sorted(checked)]
    run.counts.update(frames=det.frames, batches=det.batches, clips=k)
    if det.stage_counts:
        peak = {key: int(max(c[key].max() for c in det.stage_counts))
                for key in det.stage_counts[0]}
        print("portbench: %s stage counts, most per image in the window: %s"
              % (run.config["detector"]["model"], peak), file=sys.stderr)
    print("portbench: clip runs %s" % json.dumps(clip_report(run.spans, len(clips))),
          file=sys.stderr)
    run.attempted = det.frames
    run.e2e["frames_per_s"] = det.frames / elapsed


PIPELINE = ("decode:wait", "detect:submit", "detect:collect", "host:postprocess")


def clip_report(spans, n_clips):
    """Per clip of the mix, over its runs in the window: the wall seconds
    of each run, and of those the seconds in no pipeline stage (opening
    the clip and starting its decode workers, joining the writer pool)."""
    runs = [iv for iv in spans.intervals if iv[0] == "harness:clip"]
    stages = sorted((iv for iv in spans.intervals if iv[0] in PIPELINE), key=lambda iv: iv[1])
    out = {"wall_s": [[] for _ in range(n_clips)], "outside_s": [[] for _ in range(n_clips)]}
    for k, (_, t0, t1) in enumerate(sorted(runs, key=lambda iv: iv[1])):
        inside = sum(b - a for _, a, b in stages if a >= t0 and b <= t1)
        out["wall_s"][k % n_clips].append(round((t1 - t0) / 1e9, 4))
        out["outside_s"][k % n_clips].append(round((t1 - t0 - inside) / 1e9, 4))
    return out


def release(run):
    det = run.state.pop("det")
    run.state["stage_counts"] = det.stage_counts
    del det


def check(run):
    """One pass over the clips, drawn from the seed among the first
    ``check_among``, decoded again and recomputed by the reference."""
    cfg, tr = run.config, run.traffic
    dev = device_of(run)
    ref = models.reference_detector(cfg).to(dev).eval()
    seeding.load_state_(ref, run.state["det_state"])
    run.state["reference"] = ref
    run.state["check_frames"] = [RP.read_frames(chk["clip"], tr["video_step"])
                                 for chk in run.state["checked"]]
    run.state["frame_shape"] = run.state["check_frames"][0][1][0].shape
    with models.kernel_inputs(cfg) as calls:
        run.state["ref_det"] = [models.reference_detect(cfg, ref, frames, tr["batch_size"])
                                for _, frames in run.state["check_frames"]]
    run.state["kernel_calls"] = calls
    run.state["ref_kept"] = _kept(run, run.state["ref_det"])
    values, n_det = _values(run, [chk["detections"] for chk in run.state["checked"]],
                            _named(chk["crops"] for chk in run.state["checked"]))
    print("portbench: checked clip runs %s: %d frames, %d detections, %d reference crops"
          % ([chk["run"] for chk in run.state["checked"]],
             sum(len(f) for _, f in run.state["check_frames"]), n_det,
             len(run.state["ref_kept"])), file=sys.stderr)
    run.counts.update(checked_detections=n_det, checked_crops=len(run.state["ref_kept"]))
    return judge.compare(values, registry.limits(run.name))


def _named(per_clip):
    """{clip index/crop name: crop} of per-clip {name: crop} dicts."""
    return {"%d/%s" % (c, n): crop for c, crops in enumerate(per_clip)
            for n, crop in crops.items()}


def _kept(run, dets):
    """The reference's crops of the checked clips from ``dets`` (per clip,
    per frame (boxes, scores)): box rules, then the window hash dedup of
    each clip."""
    per_clip = []
    for (idx, frames), clip_dets in zip(run.state["check_frames"], dets):
        named = []
        for i, frame, (boxes, scores) in zip(idx, frames, clip_dets):
            named += RP.frame_crops(frame, i, boxes, scores, run.traffic["criteria"])
        per_clip.append(dict(RP.window_dedup(named, run.traffic["hash_thr"])))
    return _named(per_clip)


def _values(run, detections, crops):
    """The numbers of per-clip detections and all crops against the
    reference's."""
    flat = lambda per_clip: [d for clip in per_clip for d in clip]
    values, n_det = judge.detections(flat(detections), flat(run.state["ref_det"]),
                                     run.traffic["criteria"]["min_score"])
    values["kept_mismatch"] = judge.kept_crops(crops, run.state["ref_kept"])
    return values, n_det


def control(run):
    """The numbers with the reference in TF32 in the program's place, on
    the checked clips (after ``check``)."""
    ref = run.state["reference"]
    with precision.tf32(ref):
        low = [models.reference_detect(run.config, ref, frames, run.traffic["batch_size"])
               for _, frames in run.state["check_frames"]]
    return _values(run, low, _kept(run, low))[0]


def work(run):
    """The window's model FLOPs and the kernels' work, for the readers
    (the detector's module's ``work``): ``model_flops`` and per kernel
    (bytes, operations) lists; the launches of hand-written kernels whose
    work depends on the data are counted from the checked pass's inputs to
    the reference's stand-ins (a traced run checks the first pass, so
    these are the window's first launches)."""
    ref = run.state["reference"]
    dev = next(ref.parameters()).device
    h, w = run.state["frame_shape"][:2]
    frame = torch.zeros((1, h, w, 3), dtype=torch.uint8, device=dev)
    models.detector(run.config).work(run, ref, frame)


def close(run):
    for key in ("det", "reference", "check_frames", "ref_det", "ref_kept", "kernel_calls"):
        run.state.pop(key, None)
    shutil.rmtree(osp.join(run.scratch, "clips"), ignore_errors=True)
