"""BASELINE configs 4 and 5 through the port and through the JAX package on
the same inputs, with the same stand-in models as tests/test_baseline_configs.py
(its numpy ``FakeDetector`` and ``FakeEncoder``; the port's copies add the
``submit``/``collect`` split and the ``device`` its pipeline reads):

  4. classification mode: reference images, ``enc_oth_thr=0.25`` open-set
     reject, group log;
  5. a batch folder of two videos, ``video_reader="decord"`` (OpenCV where
     decord is absent), the clusters sweep "2-3" with ``clusters_save_all``.

Each run must leave the same output tree in both packages: folder names,
file names per group, and the same CSV rows (floats within 1e-4). One
exception, in config 5: the stand-in embeddings of a group differ by ~1e-4
in a 32-d one-hot, and the JAX package's float32 ``x2 - 2xy + y2``
distances err by more than that, so its k = 3 silhouette and
Davies-Bouldin scores read 0.7190 and 0.4145 against sklearn's float64
0.8055 and 0.2961. The port computes them in float64: its
``log_clustering.csv`` rows are held to sklearn's scores on the
embeddings of each k's folders instead."""

import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu import video_to_faces as jax_video_to_faces
from videotofaces_tpu_torch import video_to_faces

from test_api import FakeEncoder
from test_pipeline_detection import FakeDetector
from test_torch_grouping_pipeline import _same_csv, _same_tree, _tree

LOG = osp.join("faces", "log_clustering.csv")


class PortDetector(FakeDetector):
    device = torch.device("cpu")
    batch_size = None

    def submit(self, frames):
        return self(frames)

    def collect(self, handle):
        return handle


class PortEncoder(FakeEncoder):
    device = torch.device("cpu")


@pytest.fixture
def patched_models(monkeypatch):
    captured = {}

    def factories(pkg, det_cls, enc_cls):
        def det(style, name, dev):
            captured.setdefault(pkg, {})["det"] = (style, name)
            return det_cls()

        def enc(style, name, dev):
            captured.setdefault(pkg, {})["enc"] = (style, name)
            return enc_cls()
        return det, enc

    for pkg, det_cls, enc_cls in (("videotofaces_tpu", FakeDetector, FakeEncoder),
                                  ("videotofaces_tpu_torch", PortDetector, PortEncoder)):
        det, enc = factories(pkg, det_cls, enc_cls)
        monkeypatch.setattr(pkg + ".api.get_detector_model", det)
        monkeypatch.setattr(pkg + ".api.get_encoder_model", enc)
        monkeypatch.setattr(pkg + ".pipeline.grouping.get_encoder_model", enc)
    return captured


def _roots(tmp_path):
    return str(tmp_path / "jax" / "out"), str(tmp_path / "port" / "out")


def _config4_inputs(out):
    """Faces in <out>/faces: dark and bright groups + one mid-gray face no
    reference matches; one reference image per class in <out>/ref."""
    faces = osp.join(out, "faces")
    os.makedirs(faces)
    rng = np.random.default_rng(0)
    for i, val in enumerate([30, 220, 30, 220, 130]):
        img = np.full((64, 64, 3), val, np.uint8)
        img[:8] = rng.integers(0, 40, size=(8, 64, 3))
        cv2.imwrite(osp.join(faces, "f%02d.jpg" % i), img)
    ref = osp.join(out, "ref")
    os.makedirs(osp.join(ref, "dark"))
    os.makedirs(osp.join(ref, "bright"))
    cv2.imwrite(osp.join(ref, "dark", "r.jpg"), np.full((64, 64, 3), 25, np.uint8))
    cv2.imwrite(osp.join(ref, "bright", "r.jpg"), np.full((64, 64, 3), 225, np.uint8))
    return ref


def test_config4_classification_open_set_matches_jax(tmp_path, patched_models):
    kw = dict(mode="grouping", style="live", group_mode="classification",
              enc_dup_thr=-1, enc_oth_thr=0.25, group_log=True)
    jroot, troot = _roots(tmp_path)
    jax_video_to_faces(out_dir=jroot, ref_dir=_config4_inputs(jroot), **kw)
    video_to_faces(out_dir=troot, ref_dir=_config4_inputs(troot), device="cpu", **kw)
    assert patched_models["videotofaces_tpu_torch"] == {"enc": ("live", "facenet_vgg")}
    faces = osp.join(troot, "faces")
    assert len(os.listdir(osp.join(faces, "dark"))) == 2
    assert len(os.listdir(osp.join(faces, "bright"))) == 2
    # the open-set threshold sent the mid-gray face to "other"
    assert len(os.listdir(osp.join(faces, "other"))) == 1
    log = open(osp.join(faces, "log_classification.csv")).read()
    assert "dark" in log and "bright" in log
    _same_tree(troot, jroot)


def _config5_inputs(root):
    """Two 50-frame MJPG videos with distinct per-video texture."""
    folder = osp.join(root, "vids")
    os.makedirs(folder)
    rng = np.random.default_rng(3)
    for vi, name in enumerate(("a.avi", "b.avi")):
        vw = cv2.VideoWriter(osp.join(folder, name), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (320, 240))
        assert vw.isOpened()
        for i in range(50):
            frame = rng.integers(0, 255, size=(240, 320, 3)).astype(np.uint8)
            frame[:, :, vi] = (i * 6) % 255
            vw.write(frame)
        vw.release()
    out = osp.join(root, "out")
    os.makedirs(out)
    return folder


def test_config5_batch_folder_decord_sweep_save_all_matches_jax(tmp_path, patched_models):
    kw = dict(input_ext="avi", style="live", mode="full", video_reader="decord",
              video_step=0.5, hash_thr=0, enc_dup_thr=-1, clusters="2-3",
              clusters_save_all=True, det_scale=(1, 1, 1, 1), det_square=False,
              group_log=True)
    jroot, troot = _roots(tmp_path)
    jax_video_to_faces(input_path=_config5_inputs(osp.dirname(jroot)), out_dir=jroot, **kw)
    video_to_faces(input_path=_config5_inputs(osp.dirname(troot)), out_dir=troot,
                   device="cpu", **kw)
    assert patched_models["videotofaces_tpu_torch"] == {
        "det": ("live", "yolo"), "enc": ("live", "facenet_vgg")}
    faces = osp.join(troot, "faces")
    gdirs = sorted(d for d in os.listdir(faces) if d.startswith("G"))
    assert gdirs == ["G2", "G3"], gdirs   # save-all keeps every candidate k
    names = [f for g in gdirs for sub in os.listdir(osp.join(faces, g))
             for f in os.listdir(osp.join(faces, g, sub))]
    assert any(n.startswith("01_") for n in names)
    assert any(n.startswith("02_") for n in names)
    got, want = _tree(troot), _tree(jroot)
    assert sorted(got) == sorted(want)
    for rel in want:
        if rel.endswith(".csv") and rel != LOG:
            _same_csv(got[rel], want[rel], (troot, jroot))
        elif rel != LOG:
            assert got[rel] == want[rel], rel
    rows = [r.split(",") for r in got[LOG].decode().splitlines()]
    assert rows[0] == want[LOG].decode().splitlines()[0].split(",")
    assert [r[0] for r in rows[1:]] == ["2", "3"]
    for k, *scores in rows[1:]:
        np.testing.assert_allclose(np.asarray(scores, float),
                                   _sklearn_scores(osp.join(faces, "G" + k)), rtol=1e-4)


def _sklearn_scores(gdir):
    """sklearn's float64 silhouette, Calinski-Harabasz and Davies-Bouldin
    scores of the stand-in embeddings of the faces in ``gdir``'s groups."""
    from sklearn import metrics

    x, labels = [], []
    for label in os.listdir(gdir):
        for name in os.listdir(osp.join(gdir, label)):
            x.append(FakeEncoder()([cv2.imread(osp.join(gdir, label, name))])[0])
            labels.append(int(label))
    x = np.asarray(x, np.float64)
    return [metrics.silhouette_score(x, labels), metrics.calinski_harabasz_score(x, labels),
            metrics.davies_bouldin_score(x, labels)]
