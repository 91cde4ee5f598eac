"""Full and grouping modes through the port's entry points on the CPU:
``video_to_faces(mode="full" | "grouping")`` (clustering, classification,
the ``_test_enc`` harness, ``enc_from_memory``) and the CLI with
``-m full -d cpu``; without a card and without ``device="cpu"`` they
raise."""

import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu_torch import video_to_faces
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.models.wrappers import FaceNetEncoder, MtcnnDetector

from test_torch_facenet import few_threads, jax_facenet_params  # noqa: F401
from test_torch_mtcnn_modules import jax_mtcnn_params

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FPS = 8.0
CAPS = dict(pre1=128, post1=64, cross=256, stage2=64, stage3=32, out=8)
DET_KW = dict(video_step=1.0 / FPS, det_min_size=10, det_min_border=0)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 160x120, 4-frame mp4 of smooth seeded noise."""
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    rng = np.random.default_rng(31)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (160, 120))
    for _ in range(4):
        low = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
        vw.write(cv2.resize(low, (160, 120), interpolation=cv2.INTER_CUBIC))
    vw.release()
    return path


@pytest.fixture(scope="module")
def seeded_models():
    """Factories for models with seeded parameters that find faces in the
    video and embed them apart (see the parity tests)."""
    mtcnn = jax_mtcnn_params(seed=0, cls_shift=2.0, reg_scale=1e-4)
    facenet = jax_facenet_params(seed=1, calibrate=True)
    return (lambda style, det, dev: MtcnnDetector(dev, params=mtcnn, min_face_size=12,
                                                  caps=TM.Caps(**CAPS)),
            lambda style, enc, dev: FaceNetEncoder(dev, params=facenet))


@pytest.fixture
def patched(monkeypatch, seeded_models):
    det, enc = seeded_models
    monkeypatch.setattr("videotofaces_tpu_torch.api.get_detector_model", det)
    monkeypatch.setattr("videotofaces_tpu_torch.api.get_encoder_model", enc)
    monkeypatch.setattr("videotofaces_tpu_torch.pipeline.grouping.get_encoder_model", enc)


def _groups(faces):
    return sorted(d for d in os.listdir(faces) if osp.isdir(osp.join(faces, d)))


@pytest.mark.parametrize("from_memory", [False, True], ids=["from_disk", "from_memory"])
def test_full_mode_clusters_faces(video, tmp_path, capsys, patched, from_memory):
    video_to_faces(input_path=video, out_dir=str(tmp_path), mode="full", style="live",
                   det_model="mtcnn", device="cpu", clusters="2-3", save_dupes=True,
                   enc_from_memory=from_memory, **DET_KW)
    out = capsys.readouterr().out
    assert "Saved a total of" in out and "Clustering images into 2, 3 groups" in out
    assert out.rstrip().endswith("Done")
    faces = str(tmp_path / "faces")
    groups = _groups(faces)
    assert len(groups) in (2, 3) and all(g.isdigit() for g in groups)
    grouped = sum(len(os.listdir(osp.join(faces, g))) for g in groups)
    assert grouped > 3
    assert not [f for f in os.listdir(faces) if f.endswith(".jpg")]   # all moved
    assert osp.isfile(osp.join(faces, "log_clustering.csv"))


@pytest.fixture(scope="module")
def face_dir(tmp_path_factory):
    """8 face-like crops of mixed sizes in <out>/faces."""
    out = tmp_path_factory.mktemp("faces_src")
    os.makedirs(out / "faces")
    rng = np.random.default_rng(8)
    for i in range(8):
        low = rng.integers(0, 256, (6, 6, 3)).astype(np.uint8)
        img = cv2.resize(low, (60 + 7 * i, 80), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(str(out / "faces" / ("f%02d.jpg" % i)), img)
    return str(out)


def _copy_faces(src, dst):
    os.makedirs(osp.join(dst, "faces"))
    for f in os.listdir(osp.join(src, "faces")):
        img = cv2.imread(osp.join(src, "faces", f))
        cv2.imwrite(osp.join(dst, "faces", f), img)


def test_grouping_mode_clustering(face_dir, tmp_path, capsys, patched):
    _copy_faces(face_dir, str(tmp_path))
    video_to_faces(input_path=str(tmp_path), mode="grouping", style="live",
                   device="cpu", clusters="2,4", clusters_save_all=True)
    out = capsys.readouterr().out
    assert "Found 8 images" in out and out.rstrip().endswith("Done")
    assert _groups(str(tmp_path / "faces")) == ["G2", "G4"]
    assert len(os.listdir(tmp_path / "faces" / "G4")) == 4


def test_grouping_mode_classification(face_dir, tmp_path, capsys, patched):
    _copy_faces(face_dir, str(tmp_path))
    refs = tmp_path / "refs"
    for name, src in (("alice", "f00.jpg"), ("bob", "f07.jpg")):
        os.makedirs(refs / name)
        cv2.imwrite(str(refs / name / "r.jpg"), cv2.imread(str(tmp_path / "faces" / src)))
    video_to_faces(input_path=str(tmp_path), mode="grouping", style="live", device="cpu",
                   group_mode="classification", ref_dir=str(refs), enc_dup_thr=-1)
    out = capsys.readouterr().out
    assert "Found 2 classes in ref_dir: alice, bob" in out and out.rstrip().endswith("Done")
    faces = str(tmp_path / "faces")
    assert set(_groups(faces)) <= {"alice", "bob", "other"}
    assert sum(len(os.listdir(osp.join(faces, g))) for g in _groups(faces)) == 8
    assert "f00.jpg" in os.listdir(osp.join(faces, "alice"))
    assert osp.isfile(osp.join(faces, "log_classification.csv"))


def test_test_enc_harness(face_dir, tmp_path, capsys, patched):
    _copy_faces(face_dir, str(tmp_path))
    (tmp_path / "labels.txt").write_text("\n".join(["1", "2"] * 4))
    refs = tmp_path / "refs"
    for name, src in (("a", "f00.jpg"), ("b", "f01.jpg")):
        os.makedirs(refs / name)
        cv2.imwrite(str(refs / name / "r.jpg"), cv2.imread(str(tmp_path / "faces" / src)))
    video_to_faces(input_path=str(tmp_path), mode="grouping", style="live", device="cpu",
                   ref_dir=str(refs), _test_enc=True)
    lines = capsys.readouterr().out.splitlines()
    tag = "classification accuracy / rand score for clustering / silhouette score for clustering"
    assert tag in lines
    acc, rand, sil = (float(v) for v in lines[lines.index(tag) - 1].split("/"))
    assert 0 <= acc <= 1 and 0 <= rand <= 1 and -1 <= sil <= 1


def test_full_mode_default_weights_reaches_done(video, tmp_path, capsys):
    video_to_faces(input_path=video, out_dir=str(tmp_path), mode="full", style="live",
                   det_model="mtcnn", device="cpu", **DET_KW)
    assert capsys.readouterr().out.rstrip().endswith("Done")


def test_cli_full_on_cpu(video, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "videotofaces_tpu_torch", "-i", video, "-o", str(tmp_path),
         "-m", "full", "-s", "live", "--det-model", "mtcnn", "-d", "cpu",
         "--video-step", str(1.0 / FPS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})     # as few_threads does here
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Saved a total of" in r.stdout and r.stdout.rstrip().endswith("Done")


@pytest.mark.parametrize("mode", ["full", "grouping"])
def test_entry_points_raise_without_a_card(video, face_dir, monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = video if mode == "full" else face_dir
    with pytest.raises(RuntimeError, match='device="cpu"'):
        video_to_faces(input_path=path, mode=mode, style="live", det_model="mtcnn")
