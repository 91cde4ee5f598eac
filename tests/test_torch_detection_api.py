"""Detection mode end to end: the port's ``detect_faces`` with its
``MtcnnDetector(device="cpu")`` writes the same face files as the JAX
package's for the same parameters, and the port's ``video_to_faces`` and
CLI run detection on a synthetic video."""

import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest

from videotofaces_tpu.models import mtcnn as JM
from videotofaces_tpu.models.wrappers import MtcnnDetector as JaxDetector
from videotofaces_tpu.pipeline.detection import detect_faces as jax_detect_faces
from videotofaces_tpu.specs import BoxCriteria as JCriteria
from videotofaces_tpu.specs import FrameSampling as JSampling
from videotofaces_tpu.specs import OutputLayout as JLayout
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.models.wrappers import MtcnnDetector
from videotofaces_tpu_torch.pipeline.detection import detect_faces
from videotofaces_tpu_torch.specs import BoxCriteria, FrameSampling, OutputLayout

from test_torch_mtcnn_modules import jax_mtcnn_params

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FPS, NFRAMES = 8.0, 8
CAPS = dict(pre1=128, post1=64, cross=256, stage2=64, stage3=32, out=8)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 160x120, 8-frame mp4 of smooth seeded noise."""
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    rng = np.random.default_rng(31)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (160, 120))
    for _ in range(NFRAMES):
        low = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
        vw.write(cv2.resize(low, (160, 120), interpolation=cv2.INTER_CUBIC))
    vw.release()
    assert osp.getsize(path) > 0
    return path


def _faces(root):
    d = osp.join(root, "faces")
    return {fn: open(osp.join(d, fn), "rb").read() for fn in sorted(os.listdir(d))}


def test_detect_faces_writes_same_faces_as_jax(video, tmp_path):
    # small regression heads keep the random-weight boxes face-like
    params = jax_mtcnn_params(seed=0, cls_shift=2.0, reg_scale=1e-4)
    kw = dict(step=1.0 / FPS)
    crit = dict(batch_size=4, min_score=0.4, min_size=10, min_border=0)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_detect_faces([video], JaxDetector(params=params, min_face_size=12,
                                          caps=JM.Caps(**CAPS)),
                     JSampling(**kw), JCriteria(**crit), JLayout(jroot), 8)
    paths = detect_faces([video], MtcnnDetector(device="cpu", params=params,
                                                min_face_size=12,
                                                caps=TM.Caps(**CAPS)),
                         FrameSampling(**kw), BoxCriteria(**crit), OutputLayout(troot), 8)
    want, got = _faces(jroot), _faces(troot)
    assert len(want) > 0, "no faces written — tune the test parameters"
    assert sorted(got) == sorted(want)
    for fn in want:
        assert got[fn] == want[fn], fn
    assert sorted(osp.basename(p) for p in paths) == sorted(got)


def test_video_to_faces_detection_on_cpu(video, tmp_path, capsys):
    from videotofaces_tpu_torch import video_to_faces

    video_to_faces(input_path=video, out_dir=str(tmp_path), mode="detection",
                   style="live", det_model="mtcnn", device="cpu",
                   video_step=1.0 / FPS)
    out = capsys.readouterr().out
    assert "Saved a total of" in out and "Stage timings" in out and "Done" in out
    assert osp.isdir(tmp_path / "faces")


def test_cli_detection_on_cpu(video, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "videotofaces_tpu_torch", "-i", video, "-o", str(tmp_path),
         "-m", "detection", "-s", "live", "--det-model", "mtcnn", "-d", "cpu",
         "--video-step", str(1.0 / FPS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Saved a total of" in r.stdout and "Done" in r.stdout
    assert osp.isdir(tmp_path / "faces")
