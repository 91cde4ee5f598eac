"""How the face-logit calibration of a configuration's detector was
chosen: seeded weights, the heads calibrated (``models.calibrate_heads``)
to a grid of candidates per frame, then the program's detector on the first
sampled frames of the video mix, reporting per setting the faces the box
filter keeps per frame, the detector's stage counts where its module reads
them (MTCNN's, against its buffers) and the calibration's values per layer
(the configuration's ``seed0`` records those of seed 0).

    python3 portbench/calibrate.py <config> [--seeds 0 1 2] [--frames 8] \
        [--grid LAYER=K1,K2,...]...

A layer without a grid keeps the configuration's value. Needs a CUDA
device."""

import argparse
import itertools
import json
import os.path as osp
import sys
import tempfile

import numpy as np


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--grid", action="append", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
    from portbench import harness, models, registry, seeding, traffic
    from portbench.reference import pipeline as RP

    harness.prepare_environment()
    import torch

    from videotofaces_tpu_torch import config as V2F

    cfg = registry.config(args.config)
    tr = registry.traffic("video")
    crit = tr["criteria"]
    V2F.set_precision(cfg["precision"])
    dev = torch.device("cuda")
    grids = {}
    for g in args.grid:
        layer, values = g.split("=")
        grids[layer] = [float(v) for v in values.split(",")]
    specs = cfg["detector"]["calibrate"]
    axes = [grids.get(s["layer"], [s["per_frame"]]) for s in specs]
    stage_counts = getattr(models.detector(cfg), "stage_counts", None)
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as tmp:
            clips = traffic.make_clips(tmp, seed, tr["clip"])
            calib = RP.spread_frames(clips, tr["video_step"], cfg["detector"]["calibration_frames"])
            frames = RP.spread_frames(clips, tr["video_step"], args.frames)
        det = None
        for means in itertools.product(*axes):
            c = dict(cfg, detector=dict(cfg["detector"], calibrate=[
                dict(s, per_frame=m) for s, m in zip(specs, means)]))
            state, calibration = models.detector_state(c, seed, dev, calib)
            if det is None:
                det = models.program_detector(c, state, dev)
                det.batch_size = 4
            else:
                seeding.load_state_(det.model, state)
            kept, raw, caps = [], [], {}
            for s in range(0, len(frames), 4):
                h = det.submit(frames[s:s + 4])
                out = det.collect(h)
                per = list(zip(out[0], out[1])) if isinstance(out, tuple) else \
                    [(o[:, :4], o[:, 4]) for o in out]
                counts = stage_counts(h) if stage_counts else None
                for k, v in (counts or {}).items():
                    caps[k] = max(caps.get(k, 0), int(v.max()))
                for f, (b, sc) in zip(frames[s:s + 4], per):
                    raw.append(len(sc))
                    kept.append(int(RP.passes(RP.round_out(b), sc, f.shape[:2], crit["min_score"],
                                              crit["min_size"], crit["min_border"]).sum()))
            print("seed %d per frame %s: detections/frame %.1f kept/frame %.2f (min %d max %d) %s"
                  % (seed, list(means), np.mean(raw), np.mean(kept), min(kept), max(kept), caps),
                  flush=True)
            print("seed %d calibration %s" % (seed, json.dumps(calibration)), flush=True)
        del det
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
