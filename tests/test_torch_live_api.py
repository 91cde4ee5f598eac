"""The live-action path through the entry points on the CPU:
``video_to_faces(style="live")`` with its defaults (``mode="full"``: YOLOv3,
then FaceNet-VGG embeddings, hash and embedding dedup, K-means), the CLI
with ``-s live -d cpu``, and BASELINE config 3 (anime + YOLO + ViT-L with
both dedups), each against the JAX package's on the same seeded
parameters. Each must leave the same face files in the same cluster folders
(CSVs equal but for float columns, held to 1e-4).

The model factories are patched to pass the seeded parameters and a small
input size (YOLO's ``max_side`` 160, the video's own); the YOLO objectness
and class biases are shifted by +2 so that detections pass
``det_min_score=0.4``, and its regression columns scaled by 0.6 so that box
sizes spread and ``det_min_size=22`` keeps a few boxes per frame. On both
sides the ViT-L16 constructor is narrowed to dim 128, depth 2, so that the
CPU runs stay short; every other step is the packages' own."""

import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu import __main__ as JMAIN
from videotofaces_tpu import api as JAPI
from videotofaces_tpu.models import vit as JV
from videotofaces_tpu.pipeline import detection as JDET
from videotofaces_tpu.pipeline import grouping as JG
from videotofaces_tpu_torch import __main__ as TMAIN
from videotofaces_tpu_torch import api as TAPI
from videotofaces_tpu_torch import video_to_faces
from videotofaces_tpu_torch.models import vit as TV
from videotofaces_tpu_torch.pipeline import detection as TDET
from videotofaces_tpu_torch.pipeline import grouping as TG

from test_torch_facenet import few_threads, jax_facenet_params  # noqa: F401
from test_torch_grouping_pipeline import _same_tree
from test_torch_vit import jax_vit_params
from test_torch_yolo import jax_yolo_params

FPS, NFRAMES = 8.0, 4
SMALL_VIT = dict(dim=128, depth=2)
DET_KW = dict(max_side=160)
RUN_KW = dict(video_step=1.0 / FPS, det_min_size=22, det_min_border=0, clusters="2-3",
              enc_dup_thr=0.02, group_log=True)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 160x120, 4-frame mp4 of smooth seeded noise."""
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    rng = np.random.default_rng(31)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (160, 120))
    for _ in range(NFRAMES):
        low = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
        vw.write(cv2.resize(low, (160, 120), interpolation=cv2.INTER_CUBIC))
    vw.release()
    return path


@pytest.fixture(scope="module")
def params():
    return (jax_yolo_params(0, head_shift=2.0, reg_scale=0.6),
            jax_facenet_params(seed=1, calibrate=True), jax_vit_params(3, **SMALL_VIT))


@pytest.fixture
def seeded(monkeypatch, params):
    """Both packages' factories with the seeded parameters (the JAX ones on
    one device), and their ViT-L16 narrowed to SMALL_VIT."""
    yolo, facenet, vit = params
    monkeypatch.setattr(JV, "vit_l16", lambda: JV.ViT(**SMALL_VIT))
    monkeypatch.setattr(TV, "L16", dict(TV.L16, **SMALL_VIT))

    def enc_params(enc):
        return vit if enc.startswith("vit") else facenet

    def jdet(style, det, dev):
        return JDET.get_detector_model(style, det, dev, mesh=None, params=yolo, **DET_KW)

    def jenc(style, enc, dev):
        return JG.get_encoder_model(style, enc, dev, mesh=None, params=enc_params(enc))

    def tdet(style, det, dev):
        return TDET.get_detector_model(style, det, dev, params=yolo, **DET_KW)

    def tenc(style, enc, dev):
        return TG.get_encoder_model(style, enc, dev, params=enc_params(enc))

    for mod, det, enc in ((JAPI, jdet, jenc), (TAPI, tdet, tenc)):
        monkeypatch.setattr(mod, "get_detector_model", det)
        monkeypatch.setattr(mod, "get_encoder_model", enc)


def _groups(faces):
    return sorted(d for d in os.listdir(faces) if osp.isdir(osp.join(faces, d)))


def _check_clustered(root, ks=(2, 3)):
    faces = osp.join(root, "faces")
    groups = _groups(faces)
    assert len(groups) in ks
    assert sum(len(os.listdir(osp.join(faces, g))) for g in groups) > 5
    assert not [f for f in os.listdir(faces) if f.endswith(".jpg")]     # all moved
    assert osp.isfile(osp.join(faces, "log_clustering.csv"))


def _roots(tmp_path):
    roots = str(tmp_path / "jax"), str(tmp_path / "port")
    for r in roots:
        os.makedirs(r)
    return roots


def test_live_defaults_match_jax(video, tmp_path, capsys, seeded):
    """``video_to_faces(input_path, out_dir, style="live")``: YOLOv3 ->
    crops -> hash dedup -> FaceNet-VGG -> embedding dedup -> K-means."""
    jroot, troot = _roots(tmp_path)
    JAPI.video_to_faces(input_path=video, out_dir=jroot, style="live", **RUN_KW)
    capsys.readouterr()
    video_to_faces(input_path=video, out_dir=troot, style="live", device="cpu", **RUN_KW)
    out = capsys.readouterr().out
    assert "Initializing YOLOv3" in out and "Initializing FaceNet VGG" in out
    assert "Clustering images into 2, 3 groups" in out and out.rstrip().endswith("Done")
    _check_clustered(troot)
    _same_tree(troot, jroot)


def test_cli_live_matches_jax(video, tmp_path, capsys, seeded):
    """``-s live -d cpu`` through each package's ``__main__.main``."""
    roots = dict(zip(("jax", "port"), _roots(tmp_path)))
    for name, main in (("jax", JMAIN.main), ("port", TMAIN.main)):
        main(["-i", video, "-o", roots[name], "-s", "live", "-d", "cpu", "--video-step",
              str(1.0 / FPS), "--det-min-size", "22", "--det-min-border", "0",
              "--clusters", "2-3", "--enc-dup-thr", "0.02", "--group-log"])
    assert capsys.readouterr().out.rstrip().endswith("Done")
    _check_clustered(roots["port"])
    _same_tree(roots["port"], roots["jax"])


def test_baseline_config3_anime_yolo_vitl_matches_jax(video, tmp_path, capsys, seeded):
    """BASELINE config 3 (tests/test_baseline_configs.py:82): style "anime"
    with the YOLO detector and ViT-L, batch 128, hash and embedding dedup
    with their logs kept (``save_dupes``)."""
    jroot, troot = _roots(tmp_path)
    kw = dict(style="anime", det_model="yolo", enc_model="vit_l", enc_batch_size=128,
              hash_thr=2, save_dupes=True, **dict(RUN_KW, clusters=2))
    JAPI.video_to_faces(input_path=video, out_dir=jroot, **kw)
    capsys.readouterr()
    video_to_faces(input_path=video, out_dir=troot, device="cpu", **kw)
    out = capsys.readouterr().out
    assert "Initializing YOLOv3" in out and "Initializing ViT L16" in out
    inter = osp.join(troot, "intermediate")
    assert osp.isfile(osp.join(inter, "log_dupes2.csv"))
    assert osp.isfile(osp.join(inter, "log_dupes3.csv"))
    _check_clustered(troot, ks=(2,))
    _same_tree(troot, jroot)


def test_live_defaults_raise_without_a_card(video, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        video_to_faces(input_path=video, style="live")
