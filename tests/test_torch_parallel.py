"""Data parallelism of the port on the CPU (``videotofaces_tpu_torch/parallel``,
``pipeline/mesh_auto.py``, ``mesh=`` on the wrappers, factories and
``FaceService``, and the sharded dedup Gram, Lloyd steps and silhouette).

A mesh may repeat a device, so ``make_mesh(devices=["cpu"] * n)`` runs n
shards on the CPU, one after another, as the JAX package's tests shard over
8 virtual CPU devices. Every sharded call is held to the port's
single-device call and, for the three ops, to the JAX package's sharded op
on its 8-device mesh, at the tolerances of tests/test_parallel.py."""

import os
import os.path as osp
import sys
import threading
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu.models.wrappers import _round_batch as jax_round_batch
from videotofaces_tpu.ops import cluster_scores as JCS
from videotofaces_tpu.ops import distances as JD
from videotofaces_tpu.ops.kmeans import kmeans_fit as jax_kmeans_fit
from videotofaces_tpu.parallel import make_mesh as jax_make_mesh
from videotofaces_tpu_torch import api as TAPI
from videotofaces_tpu_torch import config, video_to_faces
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.models import vit as TV
from videotofaces_tpu_torch.models.wrappers import (FaceNetEncoder, FrcnnDetector,
                                                    MtcnnDetector, VitEncoder,
                                                    YoloDetector, _round_batch)
from videotofaces_tpu_torch.ops import _cuda
from videotofaces_tpu_torch.ops import cluster_scores as CS
from videotofaces_tpu_torch.ops import distances as D
from videotofaces_tpu_torch.ops.kmeans import kmeans_fit
from videotofaces_tpu_torch.parallel import make_mesh, map_shards, split_rows
from videotofaces_tpu_torch.pipeline import detection as TDET
from videotofaces_tpu_torch.pipeline import grouping as TG
from videotofaces_tpu_torch.pipeline import mesh_auto
from videotofaces_tpu_torch.serve import FaceService
from videotofaces_tpu_torch.specs import BoxCriteria

from test_torch_facenet import few_threads, jax_facenet_params  # noqa: F401
from test_torch_grouping_pipeline import _same_tree
from test_torch_mtcnn_modules import jax_mtcnn_params
from test_torch_rcnn import jax_frcnn_params
from test_torch_vit import jax_vit_params
from test_torch_yolo import jax_yolo_params

# tests/test_parallel.py:97-98 (valid masks exact, boxes, scores) and
# :101-137 (K-means centres, silhouette, dedup): what the JAX package holds
# its own sharded ops to
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=0, atol=1e-5)
# encoders: tests/test_parallel.py:36 (a sharded forward vs one device)
EMB_TOL = dict(rtol=1e-3, atol=1e-5)
SMALL_VIT = dict(dim=128, depth=2)
CAPS = dict(pre1=128, post1=64, cross=256, stage2=64, stage3=32, out=8)


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def smooth(seed, n, h, w, low=10):
    rng = np.random.default_rng(seed)
    return [cv2.resize(rng.integers(0, 256, (h // low, w // low, 3)).astype(np.uint8),
                       (w, h), interpolation=cv2.INTER_CUBIC) for _ in range(n)]


def batch_sizes(wrapper, child=None):
    """Record the batch of every call of the wrapper's modules (or of their
    submodule ``child``: the R-CNN's wrapper calls its body and head)."""
    seen = []
    for m in wrapper.models.values():
        m = m if child is None else getattr(m, child)
        m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].shape[0]))
    return seen


# ---- the mesh and its policy ------------------------------------------------


def test_make_mesh_and_split_rows():
    mesh = cpu_mesh(3)
    assert mesh.shape["data"] == 3 and mesh.devices.size == 3
    assert mesh.distinct == (torch.device("cpu"),)
    blocks = split_rows(torch.arange(7), mesh)
    assert [b.tolist() for b in blocks] == [[0, 1, 2], [3, 4], [5, 6]]
    assert [len(b) for b in split_rows(np.zeros((6, 2)), mesh)] == [2, 2, 2]
    assert make_mesh(n_data=2, devices=["cpu"] * 4).shape["data"] == 2
    grid = make_mesh(n_model=2, devices=["cpu"] * 4)
    assert grid.shape == {"data": 2, "model": 2} and grid.devices.size == 4
    assert grid.devices.shape == (2, 2) and len(grid.shards) == 2
    with pytest.raises(ValueError):
        make_mesh(n_data=5, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_default_mesh(monkeypatch):
    """None on this host (no card) and under V2F_SINGLE_DEVICE=1; with two
    cards, a mesh over both. ``mesh="auto"`` is one device (None) even
    then; a mesh passed in is kept."""
    monkeypatch.delenv("V2F_SINGLE_DEVICE", raising=False)
    assert mesh_auto.default_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_auto.default_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = mesh_auto.default_mesh()
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1"]
    assert mesh_auto.resolve_mesh("auto") is None
    assert mesh_auto.resolve_mesh(mesh) is mesh and mesh_auto.resolve_mesh(None) is None
    monkeypatch.setenv("V2F_SINGLE_DEVICE", "1")
    assert mesh_auto.default_mesh() is None
    with pytest.raises(ValueError, match="auto"):
        mesh_auto.resolve_mesh("all")


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_round_batch_matches_jax(n):
    jmesh, mesh = jax_make_mesh(n_data=n), cpu_mesh(n)
    for bs in range(1, 18):
        assert _round_batch(bs, mesh) == jax_round_batch(bs, jmesh)
    assert _round_batch(5, None) == jax_round_batch(5, None) == 5


def test_map_shards_raises_and_keeps_the_callers_state():
    """The shards run in order in the calling thread; a failing shard's
    exception is raised and no later shard runs. Each shard runs in the
    caller's precision and inference mode, and may open a precision scope
    or a model call of its own inside the caller's."""
    mesh = cpu_mesh(3)
    ran = []

    def fail_second(dev, block):
        ran.append(int(block[0]))
        if int(block[0]) == 3:
            raise KeyError("shard 1")
        return int(block.sum())

    with pytest.raises(KeyError, match="shard 1"):
        map_shards(mesh, fail_second, split_rows(torch.arange(7), mesh))
    assert ran == [0, 3]
    assert map_shards(None, fail_second, [torch.arange(2)], device=torch.device("cpu")) == [1]

    caller = threading.current_thread()

    def state(dev, block):
        with config.model_call(), config.precision_scope("highest"):
            inner = config.get_precision_name()
        return (dev, config.get_precision_name(), inner, torch.is_inference_mode_enabled(),
                threading.current_thread() is caller)

    with config.precision_scope("default"), config.model_call(), torch.inference_mode():
        got = map_shards(mesh, state, split_rows(torch.arange(3), mesh))
    assert got == [(torch.device("cpu"), "default", "highest", True, True)] * 3


def test_launch_counter_is_exact_across_threads():
    """Threads that launch at once lose no count in ``count_launch``."""
    def fn():
        pass

    fn.launches = 0
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_cuda.count_launch(fn)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert fn.launches == 16 * 2000


# ---- the sharded ops, against the JAX package's sharded ops -----------------


def test_sharded_dedup_cosine_matches_jax_and_single_device():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(133, 32)).astype(np.float32)
    x[40] = x[7] * 1.7  # cosine-identical pair
    jm, ji = JD.dedup_cosine(x, mesh=jax_make_mesh())
    ref_m, ref_i = D.dedup_cosine(torch.from_numpy(x))
    for n in (2, 4):
        got_m, got_i = D.dedup_cosine(torch.from_numpy(x), mesh=cpu_mesh(n))
        np.testing.assert_allclose(got_m.numpy(), ref_m.numpy(), atol=1e-6)
        np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
        np.testing.assert_allclose(got_m.numpy(), np.asarray(jm), atol=1e-6)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    assert int(got_i[40]) == 7


def test_sharded_kmeans_matches_jax_and_single_device():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(203, 24)).astype(np.float32)  # deliberately not /4
    x[:70] += 4.0
    x[70:150] -= 4.0
    jl, jc, ji = jax_kmeans_fit(x, 3, random_state=0, mesh=jax_make_mesh())
    ref_l, ref_c, ref_i = kmeans_fit(x, 3, random_state=0, device="cpu")
    got_l, got_c, got_i = kmeans_fit(x, 3, random_state=0, mesh=cpu_mesh(4))
    for labels, centers, inertia in ((ref_l, ref_c, ref_i), (jl, jc, ji)):
        np.testing.assert_array_equal(got_l, labels)
        np.testing.assert_allclose(got_c, centers, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_i, inertia, rtol=1e-4)
    with pytest.raises(ValueError, match="not both"):
        kmeans_fit(x, 3, device="cpu", mesh=cpu_mesh(2))


def test_sharded_silhouette_matches_jax_and_single_device():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(157, 16)).astype(np.float32)
    labels = rng.integers(0, 4, size=157)
    want = JCS.silhouette_score(x, labels, 4, mesh=jax_make_mesh())
    ref = CS.silhouette_score(x, labels, 4, device="cpu")
    got = CS.silhouette_score(x, labels, 4, mesh=cpu_mesh(4))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the port's distance blocks are float64, the JAX package's the float32
    # expansion x2 - 2xy + y2: its rounding (~1e-7 per distance here) moves
    # this mean of 157 ratios near 0 by ~2e-6 on one device as on eight
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref, CS.silhouette_score(x, labels, 4, device="cpu"))


# ---- the five wrappers, sharded against one device --------------------------


@pytest.fixture(scope="module")
def mtcnn_params():
    return jax_mtcnn_params(seed=0, cls_shift=2.0, reg_scale=1e-4)


@pytest.fixture(scope="module")
def facenet_params():
    return jax_facenet_params(seed=1, calibrate=True)


@pytest.fixture(scope="module")
def yolo_params():
    return jax_yolo_params(0, head_shift=2.0, reg_scale=0.6)


def _assert_same_detections(got, want):
    """Per image: the same count, boxes and scores within the JAX
    package's sharded-vs-single tolerances."""
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[..., :4], w[..., :4], **BOX_TOL)


def test_sharded_mtcnn_equals_single_device(mtcnn_params, capsys):
    """3 frames on 2 shards: the batch pads to 4, 2 per shard; detections,
    landmarks and the capacity warnings equal the single-device call's."""
    frames = smooth(0, 3, 96, 128)
    kw = dict(params=mtcnn_params, min_face_size=12, caps=TM.Caps(**CAPS))
    single = MtcnnDetector("cpu", **kw)
    sharded = MtcnnDetector(mesh=cpu_mesh(2), **kw)
    assert len(sharded.models) == 1 and sharded.device == torch.device("cpu")
    seen = []
    sharded.M = SimpleNamespace(full_forward=lambda model, x, **kw: (
        seen.append(x.shape[0]), TM.full_forward(model, x, **kw))[1])
    capsys.readouterr()
    want = single(frames, return_landmarks=True)
    want_out = capsys.readouterr().out
    assert "WARNING" in want_out
    got = sharded(frames, return_landmarks=True)
    assert capsys.readouterr().out == want_out
    assert seen == [2, 2]
    (gd, gl), (wd, wl) = got, want
    assert sum(len(d) for d in wd) > 5
    _assert_same_detections(gd, wd)
    for g, w in zip(gd, wd):
        np.testing.assert_allclose(g[:, 4], w[:, 4], **SCORE_TOL)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, **BOX_TOL)


@pytest.mark.parametrize("name", ["yolo", "rcnn"])
def test_sharded_box_detectors_equal_single_device(name, yolo_params):
    """YOLOv3 at max_side 96 and Faster R-CNN on a 64 x 96 canvas, 3 frames
    on 2 shards (padded to 4)."""
    if name == "yolo":
        cls, frames = YoloDetector, smooth(2, 3, 60, 80)
        kw = dict(params=yolo_params, max_side=96)
    else:
        cls, frames = FrcnnDetector, smooth(2, 3, 48, 72, low=8)
        kw = dict(params=jax_frcnn_params(0), resize_spec=(64, 96), proposal_cap=64,
                  out_top=20)
    single = cls("cpu", **kw)
    sharded = cls(mesh=cpu_mesh(2), **kw)
    seen = batch_sizes(sharded, "body" if name == "rcnn" else None)
    with config.precision_scope("highest"):
        want = single(frames)
        got = sharded(frames)
    assert seen == [2, 2]
    (gb, gs, gc), (wb, ws, wc) = got, want
    assert sum(len(b) for b in wb) > 5
    _assert_same_detections(gb, wb)
    for g, w in zip(gs, ws):
        np.testing.assert_allclose(g, w, **SCORE_TOL)
    for g, w in zip(gc, wc):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,device_resize", [("facenet", True), ("facenet", False),
                                                ("vit", False)])
def test_sharded_encoders_equal_single_device(name, device_resize, facenet_params,
                                              monkeypatch):
    """5 crops of mixed sizes on 2 shards (padded to 6, 3 per shard):
    FaceNet through the K5 path and the host cv2 path, a narrow ViT through
    the host path."""
    rng = np.random.default_rng(4)
    crops = [cv2.resize(rng.integers(0, 256, (6, 6, 3)).astype(np.uint8),
                        (60 + 9 * i, 72 + 5 * i), interpolation=cv2.INTER_CUBIC)
             for i in range(5)]
    if name == "facenet":
        cls, kw = FaceNetEncoder, dict(params=facenet_params, device_resize=device_resize)
    else:
        monkeypatch.setattr(TV, "B16", dict(TV.B16, **SMALL_VIT))
        cls, kw = VitEncoder, dict(params=jax_vit_params(3, **SMALL_VIT))
    want = cls("cpu", **kw)(crops)
    sharded = cls(mesh=cpu_mesh(2), **kw)
    seen = batch_sizes(sharded)
    got = sharded(crops)
    assert seen == [3, 3] and got.shape == want.shape == (5, want.shape[1])
    np.testing.assert_allclose(got, want, **EMB_TOL)


def test_factories_take_the_jax_signature(yolo_params, facenet_params):
    """``mesh=None`` (the JAX package's single-device call), ``mesh="auto"``
    beside a named device, and an explicit mesh."""
    det = TDET.get_detector_model("live", "yolo", "cpu", mesh=None, params=yolo_params,
                                  max_side=96)
    enc = TG.get_encoder_model("live", "default", "cpu", mesh=None, params=facenet_params)
    assert det.mesh is None and enc.mesh is None and det.device == torch.device("cpu")
    assert TDET.get_detector_model("live", "yolo", "cpu", params=yolo_params).mesh is None
    mesh = cpu_mesh(2)
    det = TDET.get_detector_model("live", "mtcnn", None, mesh=mesh)
    assert det.mesh is mesh and det.devices == tuple(mesh.devices)
    with pytest.raises(ValueError, match="not both"):
        TG.get_encoder_model("live", "facenet_vgg", "cpu", mesh=mesh,
                             params=facenet_params)


def test_face_service_with_a_mesh_equals_one_device(yolo_params, facenet_params):
    """``FaceService(mesh=...)`` shards both models; a detect request of 3
    frames (bucket 4, 2 per shard) and an embed request equal ``mesh=None``
    on the CPU. Its warmup runs every replica."""
    kw = dict(det_kw=dict(params=yolo_params, max_side=96),
              enc_kw=dict(params=facenet_params), max_batch=4,
              criteria=BoxCriteria(min_score=0.0, min_size=1, min_border=0))
    single = FaceService(mesh=None, device="cpu", **kw)
    sharded = FaceService(mesh=cpu_mesh(2), **kw)
    assert sharded.detector.mesh is sharded.encoder.mesh
    assert sharded.device == torch.device("cpu")
    seen = batch_sizes(sharded.detector)
    sharded.warmup(resolutions=((60, 80),), batches=(1,), embed_batches=(1,))
    assert seen == [1, 1]
    frames = smooth(5, 3, 60, 80)
    with config.precision_scope("highest"):
        want, got = single.detect(frames), sharded.detect(frames)
    assert sum(len(b) for b, _ in want) > 5
    for (gb, gs), (wb, ws) in zip(got, want, strict=True):
        np.testing.assert_allclose(gb, wb, **BOX_TOL)
        np.testing.assert_allclose(gs, ws, **SCORE_TOL)
    np.testing.assert_allclose(sharded.embed(frames), single.embed(frames), **EMB_TOL)


# ---- the whole API through the factories ------------------------------------


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 160 x 120, 4-frame mp4 of smooth seeded noise."""
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (160, 120))
    for f in smooth(31, 4, 120, 160, low=10):
        vw.write(f)
    vw.release()
    return path


def test_video_to_faces_sharded_equals_single_device(video, tmp_path, monkeypatch,
                                                     mtcnn_params, facenet_params):
    """``video_to_faces(mode="full", style="live", det_model="mtcnn")``
    through the real factories, given a 2-shard CPU mesh, writes the tree
    the same run writes with the factories' default ``mesh="auto"`` (one
    device; tests/test_mesh_pipeline.py's check of the JAX package)."""
    built = []

    def factories(mesh):
        kw = {} if mesh is None else {"mesh": mesh}

        def det(style, name, dev):
            built.append(TDET.get_detector_model(
                style, name, dev if mesh is None else None, params=mtcnn_params,
                min_face_size=12, caps=TM.Caps(**CAPS), **kw))
            return built[-1]

        def enc(style, name, dev):
            built.append(TG.get_encoder_model(style, name, dev if mesh is None else None,
                                              params=facenet_params, **kw))
            return built[-1]

        return det, enc

    roots = {}
    for tag, mesh in (("mesh", cpu_mesh(2)), ("solo", None)):
        det, enc = factories(mesh)
        monkeypatch.setattr(TAPI, "get_detector_model", det)
        monkeypatch.setattr(TAPI, "get_encoder_model", enc)
        roots[tag] = str(tmp_path / tag)
        os.makedirs(roots[tag])
        video_to_faces(input_path=video, out_dir=roots[tag], mode="full", style="live",
                       det_model="mtcnn", clusters="2-3", video_step=1 / 8.0,
                       det_min_size=10, det_min_border=0, device="cpu")
    assert [m.mesh is not None for m in built] == [True, True, False, False]
    faces = osp.join(roots["solo"], "faces")
    assert sum(len(os.listdir(osp.join(faces, g))) for g in os.listdir(faces)
               if osp.isdir(osp.join(faces, g))) > 3
    _same_tree(roots["mesh"], roots["solo"])
