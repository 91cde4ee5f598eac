"""A configuration's detector is found by name, ``detectors/<model>.py``
(``registry.detector``): the repo's detectors are the R-CNN and MTCNN, an
unknown one raises naming the file looked for, and a new detector is new
files only: a toy detector written into a copy of the benchmark runs a
whole (tiny, CPU) cell, set-up to the per-layer readers, with no file that
was there edited but BENCHMARK.json."""

import glob
import json
import os
import os.path as osp
import shutil
import subprocess
import sys

import pytest

from portbench import models, registry

ROOT = registry.ROOT
FUNCTIONS = ("reference", "program", "detect", "calibrate", "kernel_inputs", "work")

# The toy: a 1x1 convolution scores each pixel; the 8 best cells of the
# 4x4-pooled score map give 24 px boxes, thinned by the reference's plain
# NMS, which stands in for a hand-written kernel of the program.
TOY = '''"""A toy detector for the harness's tests."""

import numpy as np
import torch
import torch.nn.functional as F

from portbench import flops, models
from portbench.reference import nms as N


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.score = torch.nn.Conv2d(3, 1, 1)

    def forward(self, x):
        return self.score(x.permute(0, 3, 1, 2).float() / 255.0)[:, 0]


def _boxes(net, x, nms):
    pooled = F.avg_pool2d(net(x)[:, None], 4)[:, 0]
    logits, idx = pooled.flatten(1).topk(8)
    cy = (idx // pooled.shape[2]).float() * 4 + 2
    cx = (idx % pooled.shape[2]).float() * 4 + 2
    boxes = torch.stack([cx - 12, cy - 12, cx + 12, cy + 12], -1)
    scores = torch.sigmoid(logits)
    return boxes, scores, nms(boxes, scores, torch.ones_like(scores, dtype=torch.bool), 0.3)


TINY = {}


class Program:
    def __init__(self, device):
        self.model = Net().to(device).eval()
        self.device = torch.device(device)
        self.batch_size = None

    def submit(self, frames):
        arr = np.stack(frames)
        n = len(arr)
        arr = np.concatenate([arr] + [arr[-1:]] * ((self.batch_size or n) - n))
        with torch.no_grad():
            out = _boxes(self.model, torch.from_numpy(arr).to(self.device), N.nms_keep_mask)
        return [t.numpy() for t in out], n

    def collect(self, handle):
        (boxes, scores, valid), n = handle
        return ([boxes[i][valid[i]] for i in range(n)], [scores[i][valid[i]] for i in range(n)],
                [np.zeros(int(valid[i].sum()), np.int64) for i in range(n)])


def reference(cfg):
    return Net()


def program(cfg, device):
    return Program(device)


def calibrate(cfg, ref, frames):
    x = torch.from_numpy(np.stack(frames))
    with torch.no_grad():
        shift = float(ref(x).mean()) - cfg["detector"]["logit"]
        ref.score.bias -= shift
    return {"score": {"shift": shift}}


def kernel_inputs(cfg):
    def keep(boxes, scores, valid, *rest):
        return int(valid.sum())
    return [(N, "nms_keep_mask", keep)]


def detect(cfg, model, frames, batch):
    out = []
    for x, n in models.blocks(model, frames, batch):
        with torch.no_grad():
            boxes, scores, valid = _boxes(model, x, N.nms_keep_mask)
        out += models.valid_rows(boxes, scores, valid, n)
    return out


def work(run, ref, frame):
    per_frame = flops.forward_ops(ref, lambda: detect(run.config, ref, [frame[0].numpy()], 1))
    run.work["model_flops"] = per_frame * run.counts["frames"]
    run.work["toy_nms"] = list(run.state["kernel_calls"])
'''


def test_the_repo_has_the_rcnn_and_mtcnn_detectors():
    found = sorted(osp.splitext(osp.basename(p))[0]
                   for p in glob.glob(osp.join(registry.HERE, "detectors", "*.py")))
    assert found == ["mtcnn", "rcnn"]
    for name in found:
        mod = registry.detector(name)
        assert all(callable(getattr(mod, f)) for f in FUNCTIONS), name
        assert isinstance(mod.TINY, dict)
    bench = registry.benchmark()
    assert {registry.config(c["name"])["detector"]["model"] for c in bench["configs"]} <= set(found)


def test_unknown_detector_names_the_file_it_looked_for(tmp_path):
    want = osp.join(registry.HERE, "detectors", "nodetector.py")
    with pytest.raises(FileNotFoundError, match=want.replace(".", r"\.")):
        models.reference_detector({"detector": {"model": "nodetector"}})
    with pytest.raises(FileNotFoundError, match="toy"):
        registry.detector("toy", here=str(tmp_path))
    (tmp_path / "detectors").mkdir()
    (tmp_path / "detectors" / "toy.py").write_text(TOY)
    toy = registry.detector("toy", here=str(tmp_path))
    assert toy.__file__ == str(tmp_path / "detectors" / "toy.py")
    assert all(callable(getattr(toy, f)) for f in FUNCTIONS)


def test_a_new_detector_is_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(osp.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}

    (pb / "detectors" / "toy.py").write_text(TOY)
    cfg = {"name": "toy_detector", "precision": "highest", "dtype": "float32",
           "detector": {"model": "toy", "logit": -1.0, "calibration_frames": 2}}
    (pb / "configs" / "toy_detector.json").write_text(json.dumps(cfg))
    cell = "toy_detector.video"
    (pb / "limits" / (cell + ".json")).write_text(
        (pb / "limits" / "live_mtcnn_facenet.video.json").read_text())
    (pb / "metrics" / "toy_nms_candidates.py").write_text(
        '"""Candidates into the toy\'s NMS per call."""\n\n\ndef read(run):\n'
        '    calls = run.work.get("toy_nms")\n'
        '    return sum(calls) / len(calls) if calls else None\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_detector", "source": "https://example.org/toy",
                             "file": "portbench/configs/toy_detector.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": cell, "config": "toy_detector", "traffic": "video",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s", "mfu.video"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "toy_nms_candidates", "unit": "boxes", "better": "higher",
                               "source": "program_counter", "layer": "kernels",
                               "moves": "frames_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    # a whole (tiny, CPU) run of the toy's cell in the copy: set-up
    # (detector_state, program_detector), window, check (reference_detect
    # under kernel_inputs), work and the readers that need no device trace
    script = (
        "import sys, json, importlib\n"
        "sys.path.insert(0, %r)\n"
        "sys.path.append(%r)\n"
        "from portbench import harness, models, registry\n"
        "from portbench.tests import tiny\n"
        "bench = registry.benchmark()\n"
        "cell = registry.cell(bench, %r)\n"
        "cfg = registry.config(cell['config'])\n"
        "cfg, tr = tiny.shrink(cfg, registry.traffic(cell['traffic']))\n"
        "run = harness.Run(cell, cfg, tr, 2999999929, 0.5, True, %r)\n"
        "run.state['device'] = 'cpu'\n"
        "drv = importlib.import_module('portbench.drivers.' + tr['kind'])\n"
        "drv.setup(run); harness._window(drv, run); drv.release(run)\n"
        "compared = drv.check(run)\n"
        "drv.work(run)\n"
        "print(json.dumps({'compared': compared, 'frames': run.counts['frames'],\n"
        " 'detections': run.counts['checked_detections'],\n"
        " 'flops': run.work['model_flops'], 'calls': len(run.work['toy_nms']),\n"
        " 'mfu': registry.reader('mfu.video')(run),\n"
        " 'candidates': registry.reader('toy_nms_candidates')(run),\n"
        " 'toy': models.detector(cfg).__file__}))\n"
        "drv.close(run)\n" % (str(root), ROOT, cell, str(tmp_path)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["toy"] == str(pb / "detectors" / "toy.py")
    assert "calibration {\"score\"" in out.stderr
    assert all(c["value"] <= c["limit"] for c in res["compared"].values()), res["compared"]
    assert res["frames"] > 0 and res["detections"] > 0
    # the 1x1 convolution: 3 multiply-adds per pixel of a 192 x 112 frame
    assert res["flops"] == res["frames"] * 2 * 3 * 112 * 192
    # one NMS call per checked batch of 2, 8 candidates an image
    assert res["calls"] > 0 and res["candidates"] == 16 and res["mfu"] > 0
