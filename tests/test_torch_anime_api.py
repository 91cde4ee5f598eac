"""The anime path through the entry points on the CPU: ``video_to_faces``
with its defaults (``style="anime"``, ``mode="full"``: Faster R-CNN, then
ViT-B16 embeddings, embedding dedup and K-means) and the CLI with ``-s
anime -d cpu``, each against the JAX package's on the same seeded
parameters. Both must leave the same face files in the same cluster folders
(CSVs equal but for float columns, held to 1e-4).

The model factories are patched to pass the seeded parameters and a small
input size (``resize_spec`` 120 x 160, the video's own, and 64 proposals),
and on both sides the ViT-B16 constructor is narrowed to dim 128, depth 2,
so that the CPU runs stay short; every other step is the packages' own."""

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

from test_torch_facenet import few_threads  # noqa: F401
from test_torch_grouping_pipeline import _same_tree
from test_torch_rcnn import jax_frcnn_params
from test_torch_vit import jax_vit_params

FPS, NFRAMES = 8.0, 4
SMALL_VIT = dict(dim=128, depth=2)
DET_KW = dict(resize_spec=(120, 160), proposal_cap=64, out_top=20)
RUN_KW = dict(video_step=1.0 / FPS, det_min_size=10, det_min_border=0, clusters="2-3",
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
    return jax_frcnn_params(0), jax_vit_params(3, **SMALL_VIT)


@pytest.fixture
def seeded(monkeypatch, params):
    """Both packages' factories with the seeded parameters (the JAX ones on
    one device), and their ViT-B16 narrowed to SMALL_VIT."""
    frcnn, vit = params
    monkeypatch.setattr(JV, "vit_b16", lambda: JV.ViT(**SMALL_VIT))
    monkeypatch.setattr(TV, "B16", dict(TV.B16, **SMALL_VIT))

    def jdet(style, det, dev):
        return JDET.get_detector_model(style, det, dev, mesh=None, params=frcnn, **DET_KW)

    def jenc(style, enc, dev):
        return JG.get_encoder_model(style, enc, dev, mesh=None, params=vit)

    def tdet(style, det, dev):
        return TDET.get_detector_model(style, det, dev, params=frcnn, **DET_KW)

    def tenc(style, enc, dev):
        return TG.get_encoder_model(style, enc, dev, params=vit)

    for mod, det, enc in ((JAPI, jdet, jenc), (TAPI, tdet, tenc)):
        monkeypatch.setattr(mod, "get_detector_model", det)
        monkeypatch.setattr(mod, "get_encoder_model", enc)


def _groups(faces):
    return sorted(d for d in os.listdir(faces) if osp.isdir(osp.join(faces, d)))


def _check_clustered(root):
    faces = osp.join(root, "faces")
    groups = _groups(faces)
    assert len(groups) in (2, 3)
    assert sum(len(os.listdir(osp.join(faces, g))) for g in groups) > 5
    assert not [f for f in os.listdir(faces) if f.endswith(".jpg")]     # all moved
    assert osp.isfile(osp.join(faces, "log_clustering.csv"))


def test_video_to_faces_defaults_match_jax(video, tmp_path, capsys, seeded):
    """``video_to_faces(input_path, out_dir)`` with the anime defaults:
    Faster R-CNN -> crops -> ViT -> embedding dedup -> K-means."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jroot)
    os.makedirs(troot)
    JAPI.video_to_faces(input_path=video, out_dir=jroot, **RUN_KW)
    capsys.readouterr()
    video_to_faces(input_path=video, out_dir=troot, device="cpu", **RUN_KW)
    out = capsys.readouterr().out
    assert "Initializing FasterRCNN" in out and "Initializing ViT B16" in out
    assert "Clustering images into 2, 3 groups" in out and out.rstrip().endswith("Done")
    _check_clustered(troot)
    _same_tree(troot, jroot)


def test_cli_anime_matches_jax(video, tmp_path, capsys, seeded):
    """``-s anime -d cpu`` through each package's ``__main__.main``."""
    roots = {}
    for name, main in (("jax", JMAIN.main), ("port", TMAIN.main)):
        roots[name] = str(tmp_path / name)
        os.makedirs(roots[name])
        main(["-i", video, "-o", roots[name], "-s", "anime", "-d", "cpu", "--video-step",
              str(1.0 / FPS), "--det-min-size", "10", "--det-min-border", "0",
              "--clusters", "2-3", "--enc-dup-thr", "0.02", "--group-log"])
    assert capsys.readouterr().out.rstrip().endswith("Done")
    _check_clustered(roots["port"])
    _same_tree(roots["port"], roots["jax"])


def test_detection_mode_writes_same_faces_as_jax(video, tmp_path, seeded):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jroot)
    os.makedirs(troot)
    kw = dict(mode="detection", style="anime", video_step=1.0 / FPS, det_min_size=10,
              det_min_border=0)
    JAPI.video_to_faces(input_path=video, out_dir=jroot, **kw)
    video_to_faces(input_path=video, out_dir=troot, device="cpu", **kw)
    faces = sorted(os.listdir(osp.join(troot, "faces")))
    assert len(faces) > 5
    _same_tree(troot, jroot)


def test_anime_defaults_raise_without_a_card(video, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        video_to_faces(input_path=video)
