"""The port's serving layer (``videotofaces_tpu_torch/serve.py``) on the CPU:
each case of tests/test_serve.py against the port's ``FaceService`` (the
detector's per-frame-size ``_geom`` cache and the batch shapes its network
ran stand in for the JAX jit cache), plus

- the whole ``extract`` step against the JAX package's ``FaceService`` on
  the same seeded YOLOv3 + FaceNet parameters, precision "highest": the
  same per-frame counts, identical int boxes for detections matched at
  IoU >= 0.99 both ways, scores within rtol 1e-4 / atol 1e-5 and
  embeddings within atol 1e-4 (the bound of tests/test_torch_facenet.py);
- the wire protocol across packages: the JAX client against the port's
  daemon and the port's client against the JAX daemon;
- the CLI's ``--det-max-side`` mapping per resolved detector, ``-d cpu``,
  and the device default (the card, which raises without one).

Small shapes throughout: YOLOv3 at ``max_side`` 96 on 96 x 128 frames."""

import ast
import base64
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu import config as jconfig
from videotofaces_tpu import serve as JS
from videotofaces_tpu.models.wrappers import FaceNetEncoder as JaxFaceNet
from videotofaces_tpu.models.wrappers import YoloDetector as JaxYolo
from videotofaces_tpu.specs import BoxCriteria as JaxCriteria
from videotofaces_tpu_torch import config
from videotofaces_tpu_torch import serve as TS
from videotofaces_tpu_torch.models.wrappers import (FaceNetEncoder, FrcnnDetector,
                                                    YoloDetector)
from videotofaces_tpu_torch.ops.boxes import box_iou_matrix
from videotofaces_tpu_torch.serve import (FaceService, ServeClient, _bucket,
                                          make_http_server, make_server,
                                          serve_forever)
from videotofaces_tpu_torch.specs import BoxCriteria

from test_torch_facenet import few_threads, jax_facenet_params  # noqa: F401
from test_torch_yolo import jax_yolo_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, MAX_SIDE = 96, 128, 96
CRIT = dict(min_score=0.0, min_size=1, min_border=0, scale=(1.0, 1.0, 1.0, 1.0),
            square=False)
# the parity run's rules: the pipeline's expansion and squaring, and a score
# threshold in a gap of the seeded detector's scores (~1e-3 from the nearest)
PARITY_CRIT = dict(min_score=0.5455, min_size=8, min_border=0, scale=(1.5, 1.5, 2.2, 1.2),
                   square=True)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
EMB_TOL = dict(rtol=0, atol=1e-4)


class FakeEncoder:
    """Deterministic stand-in implementing the _Encoder protocol: crops of any
    size in, [N, 4] features out (mean, std, h, w)."""

    input_size = 32
    batch_size = None

    def __call__(self, images):
        out = []
        for img in images:
            a = np.asarray(img, dtype=np.float32)
            out.append([a.mean(), a.std(), a.shape[0], a.shape[1]])
        return np.asarray(out, np.float32)


class FakeDetector:
    """Deterministic numpy stand-in in MTCNN's result form (one [n, 5]
    array per frame): n = 0..2 boxes from the frame's first byte."""

    batch_size = None

    def __call__(self, frames):
        out = []
        for f in frames:
            m = float(np.asarray(f).mean())
            n = int(f[0, 0, 0]) % 3
            out.append(np.asarray([[4.2 + k, 6.7, 40.3 + 2 * k, 50.9, m / 255.0]
                                   for k in range(n)], np.float32).reshape(n, 5))
        return out


@pytest.fixture(scope="module")
def yolo_params():
    return jax_yolo_params(0, head_shift=2.0, reg_scale=0.6)


@pytest.fixture
def make_service(yolo_params):
    def make(max_batch=8):
        det = YoloDetector("cpu", params=yolo_params, max_side=MAX_SIDE)
        det.seen = []
        det.model.register_forward_pre_hook(lambda m, args: det.seen.append(args[0].shape[0]))
        return FaceService(detector=det, encoder=FakeEncoder(), criteria=BoxCriteria(**CRIT),
                           max_batch=max_batch, device="cpu")
    return make


def _frames(n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8).astype(np.uint8)
            for _ in range(n)]


def test_ragged_out_mixed_empty_nonempty():
    """Frames with faces mixed with faces-free frames (the common case) must
    flatten without error and preserve per-frame counts."""
    from videotofaces_tpu_torch.serve import _ragged_out

    pairs = [
        {"boxes": np.ones((2, 4), np.float32), "scores": np.ones((2,), np.float32)},
        {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros((0,), np.float32)},
        {"boxes": np.ones((1, 4), np.float32), "scores": np.ones((1,), np.float32)},
    ]
    counts, (boxes, scores) = _ragged_out(pairs, ("boxes", "scores"))
    assert counts == [2, 0, 1]
    assert boxes.shape == (3, 4) and scores.shape == (3, 1)

    counts, (boxes,) = _ragged_out(
        [{"boxes": np.zeros((0, 4), np.float32)}], ("boxes",))
    assert counts == [0] and boxes.shape[0] == 0


def test_bucket_rounding():
    assert [_bucket(n, 32) for n in (1, 2, 3, 4, 5, 9, 33)] == \
        [1, 2, 4, 4, 8, 16, 32]


def test_detect_matches_direct_wrapper_call(make_service):
    svc = make_service()
    frames = _frames(3)
    res = svc.detect(frames)
    assert len(res) == 3
    # direct wrapper call at the same bucket must agree exactly
    svc.detector.batch_size = 4
    db, ds, _ = svc.detector(frames)
    for (boxes, scores), eb, es in zip(res, db, ds):
        np.testing.assert_array_equal(boxes, eb)
        np.testing.assert_array_equal(scores, es)
    # 3 frames rounded onto the 4-bucket: one padded batch shape, one geometry
    assert svc.detector.seen == [4, 4]
    assert list(svc.detector._geom) == [(H, W)]


def test_detect_chunks_above_max_batch(make_service):
    svc = make_service(max_batch=4)
    res = svc.detect(_frames(10))
    assert len(res) == 10
    # chunks of 4, 4, 2 -> buckets 4 and 2
    assert svc.detector.seen == [4, 4, 2]
    assert list(svc.detector._geom) == [(H, W)]


def test_extract_consistency_and_crops(make_service):
    svc = make_service()
    frames = _frames(2, seed=3)
    res = svc.extract(frames, return_crops=True)
    assert len(res) == 2
    enc = FakeEncoder()
    assert sum(len(r["boxes"]) for r in res) > 0
    for frame, r in zip(frames, res):
        m = len(r["boxes"])
        assert r["scores"].shape == (m,)
        assert len(r["crops"]) == m
        if m:
            assert r["embeddings"].shape == (m, 4)
            # crops are the adjusted-box slices of the frame
            for box, crop in zip(r["boxes"], r["crops"]):
                x1, y1, x2, y2 = box
                np.testing.assert_array_equal(frame[y1:y2, x1:x2], crop)
            np.testing.assert_allclose(r["embeddings"], enc(r["crops"]),
                                       rtol=1e-6)


def test_warmup_precompiles_buckets(make_service):
    svc = make_service()
    svc.warmup(resolutions=[(H, W)], batches=[3], embed_batches=[2])
    assert (H, W) in svc.detector._geom
    assert svc.detector.seen == [4]
    n_geom = len(svc.detector._geom)
    svc.detect(_frames(3))          # same bucket: no new batch shape or geometry
    assert len(svc.detector._geom) == n_geom
    assert set(svc.detector.seen) == {4}


def _connect(client_cls, path):
    """A client of the daemon at ``path``. The socket file appears at
    bind(), a moment before listen(), so a refused connection is retried."""
    for _ in range(100):
        if os.path.exists(path):
            try:
                return client_cls(path)
            except ConnectionRefusedError:
                pass
        time.sleep(0.05)
    pytest.fail("daemon socket never accepted a connection")


def test_socket_daemon_round_trip(tmp_path, make_service):
    svc = make_service()
    sock_path = str(tmp_path / "v2f.sock")
    t = threading.Thread(target=serve_forever, args=(svc, sock_path), daemon=True)
    t.start()

    client = _connect(ServeClient, sock_path)
    try:
        assert client.ping() is True

        frames = _frames(3, seed=7)
        got = client.detect(frames)
        want = svc.detect(frames)
        assert len(got) == len(want) == 3
        for (gb, gs), (wb, ws) in zip(got, want):
            np.testing.assert_allclose(gb, wb, rtol=1e-6)
            np.testing.assert_allclose(gs, ws, rtol=1e-6)

        # ragged crop sizes through the embed op
        crops = [_frames(1, h=20, w=30, seed=i)[0] for i in range(3)]
        emb = client.embed(crops)
        np.testing.assert_allclose(emb, FakeEncoder()(crops), rtol=1e-6)

        ex = client.extract(frames)
        wex = svc.extract(frames)
        for g, w in zip(ex, wex):
            np.testing.assert_array_equal(g["boxes"], w["boxes"])
            np.testing.assert_allclose(g["embeddings"],
                                       w["embeddings"].reshape(g["embeddings"].shape),
                                       rtol=1e-6)

        stats = client.stats()
        assert stats["requests"] >= 4 and stats["frames"] >= 6

        # unknown op surfaces as an error, connection stays usable
        with pytest.raises(RuntimeError, match="unknown op"):
            client._rpc({"op": "nope"})
        assert client.ping() is True

        client.shutdown()
    finally:
        client.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_http_gateway_round_trip(make_service):
    """JSON/HTTP gateway: base64 PNG frames in, JSON detections out.
    Lossless PNG makes the round trip numerically identical to a direct
    FaceService call."""
    svc = make_service()
    srv = make_http_server(svc, ("127.0.0.1", 0))
    host, port = srv.server_address[:2]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % (host, port)

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    def post(path, obj):
        req = urllib.request.Request(
            base + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    assert get("/ping")["pong"] is True

    frames = _frames(2, seed=21)
    b64 = [base64.b64encode(cv2.imencode(".png", f)[1]).decode() for f in frames]
    got = post("/detect", {"frames": b64})["results"]
    want = svc.detect(frames)
    assert len(got) == 2
    for g, (wb, ws) in zip(got, want):
        np.testing.assert_allclose(np.asarray(g["boxes"]).reshape(-1, 4), wb, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(g["scores"]), ws, rtol=1e-6)

    crops = [_frames(1, h=20, w=30, seed=31)[0]]
    cb64 = [base64.b64encode(cv2.imencode(".png", c)[1]).decode() for c in crops]
    emb = post("/embed", {"crops": cb64})["embeddings"]
    np.testing.assert_allclose(np.asarray(emb), FakeEncoder()(crops), rtol=1e-5)

    ex = post("/extract", {"frames": b64})["results"]
    assert len(ex) == 2 and all("embeddings" in r for r in ex)

    assert get("/stats")["stats"]["requests"] >= 3
    # bad payload -> 400 with error, server stays up
    with pytest.raises(urllib.error.HTTPError) as err:
        post("/detect", {"frames": ["!!notbase64ok"]})
    assert err.value.code == 400
    assert get("/ping")["pong"] is True
    post("/shutdown", {})
    t.join(timeout=10)
    assert not t.is_alive()
    srv.server_close()


def test_tcp_daemon_round_trip(make_service):
    """Same framed protocol over TCP: port 0 -> OS-assigned, read back."""
    svc = make_service()
    srv = make_server(svc, ("127.0.0.1", 0))
    host, port = srv.server_address[:2]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    client = ServeClient((host, port))
    try:
        assert client.ping() is True
        frames = _frames(2, seed=11)
        got = client.detect(frames)
        want = svc.detect(frames)
        for (gb, gs), (wb, ws) in zip(got, want):
            np.testing.assert_allclose(gb, wb, rtol=1e-6)
            np.testing.assert_allclose(gs, ws, rtol=1e-6)
        client.shutdown()
    finally:
        client.close()
    t.join(timeout=10)
    assert not t.is_alive()
    srv.server_close()


# -- the whole step against the JAX package ---------------------------------


def _smooth_frames(seed, n):
    rng = np.random.default_rng(seed)
    return [cv2.resize(rng.integers(0, 256, (H // 12, W // 12, 3)).astype(np.uint8),
                       (W, H), interpolation=cv2.INTER_CUBIC) for _ in range(n)]


@pytest.fixture(scope="module")
def extract_runs():
    """``extract`` of both packages' services on 3 seeded frames, with the
    same YOLOv3 (no head shift: a few detections per frame) and FaceNet
    parameters, precision "highest"."""
    yolo_params = jax_yolo_params(0, reg_scale=0.6)
    facenet = jax_facenet_params(seed=1, calibrate=True)
    frames = _smooth_frames(5, 3)
    jsvc = JS.FaceService(detector=JaxYolo(params=yolo_params, max_side=MAX_SIDE),
                          encoder=JaxFaceNet(params=facenet),
                          criteria=JaxCriteria(**PARITY_CRIT), max_batch=8)
    tsvc = FaceService(detector=YoloDetector("cpu", params=yolo_params, max_side=MAX_SIDE),
                       encoder=FaceNetEncoder("cpu", params=facenet),
                       criteria=BoxCriteria(**PARITY_CRIT), max_batch=8, device="cpu")
    with jconfig.precision_scope("highest"):
        want = jsvc.extract(frames)
    with config.precision_scope("highest"):
        got = tsvc.extract(frames)
    return got, want


def _matches(a, sa, b, sb, iou=0.99):
    """For each detection (box, score) of ``a``, the index of the detection
    of ``b`` that overlaps it at IoU >= iou with the nearest score (-1 where
    none overlaps): boxes clipped at the frame's edges can coincide."""
    if len(a) == 0 or len(b) == 0:
        return np.full(len(a), -1)
    m = box_iou_matrix(torch.from_numpy(a).float(), torch.from_numpy(b).float()).numpy()
    dist = np.where(m >= iou, np.abs(sa[:, None] - sb[None, :]), np.inf)
    return np.where(np.isfinite(dist.min(1)), dist.argmin(1), -1)


def test_extract_matches_jax_service(extract_runs):
    got, want = extract_runs
    assert [len(r["boxes"]) for r in got] == [len(r["boxes"]) for r in want]
    assert sum(len(r["boxes"]) for r in want) >= 3, "too few faces — reseed the test"
    for g, w in zip(got, want):
        gi = _matches(g["boxes"], g["scores"], w["boxes"], w["scores"])
        wi = _matches(w["boxes"], w["scores"], g["boxes"], g["scores"])
        assert (gi >= 0).all() and (wi >= 0).all()
        np.testing.assert_array_equal(g["boxes"], w["boxes"][gi])
        np.testing.assert_allclose(g["scores"], w["scores"][gi], **SCORE_TOL)
        np.testing.assert_allclose(g["embeddings"], w["embeddings"][gi], **EMB_TOL)


# -- the wire protocol across packages ---------------------------------------


@pytest.mark.parametrize("client_pkg, server_pkg", [("jax", "port"), ("port", "jax")])
def test_wire_compatible_across_packages(tmp_path, client_pkg, server_pkg):
    """Both packages' services wrap the same numpy stand-ins, so a reply
    through the other package's client or daemon must equal the direct
    call exactly: ping, detect, embed, extract, stats, an error reply,
    shutdown."""
    mods = {"jax": JS, "port": TS}
    server, client_mod = mods[server_pkg], mods[client_pkg]
    kw = {"device": "cpu"} if server_pkg == "port" else {}
    svc = server.FaceService(detector=FakeDetector(), encoder=FakeEncoder(), max_batch=4,
                             criteria=(BoxCriteria if server_pkg == "port"
                                       else JaxCriteria)(**CRIT), **kw)
    direct = TS.FaceService(detector=FakeDetector(), encoder=FakeEncoder(), max_batch=4,
                            criteria=BoxCriteria(**CRIT), device="cpu")
    sock_path = str(tmp_path / "v2f.sock")
    t = threading.Thread(target=server.serve_forever, args=(svc, sock_path), daemon=True)
    t.start()
    client = _connect(client_mod.ServeClient, sock_path)
    try:
        assert client.ping() is True
        frames = _frames(6, seed=4)
        assert sorted({int(f[0, 0, 0]) % 3 for f in frames}) == [0, 1, 2]
        for (gb, gs), (wb, ws) in zip(client.detect(frames), direct.detect(frames),
                                      strict=True):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gs, ws)
        crops = [_frames(1, h=10 + i, w=30 - i, seed=i)[0] for i in range(5)]
        np.testing.assert_array_equal(client.embed(crops), direct.embed(crops))
        for g, w in zip(client.extract(frames), direct.extract(frames), strict=True):
            np.testing.assert_array_equal(g["boxes"], w["boxes"])
            np.testing.assert_array_equal(g["scores"], w["scores"])
            np.testing.assert_array_equal(g["embeddings"],
                                          w["embeddings"].reshape(g["embeddings"].shape))
        assert client.stats() == direct.stats
        with pytest.raises(RuntimeError, match="unknown op"):
            client._rpc({"op": "nope"})
        client.shutdown()
    finally:
        client.close()
    t.join(timeout=10)
    assert not t.is_alive()


# -- the CLI and the device default -------------------------------------------


@pytest.mark.parametrize("args, det_cls, attr, value", [
    (["--style", "anime"], FrcnnDetector, "resize_spec", (320, 320)),
    (["--style", "live"], YoloDetector, "max_side", 320),
], ids=["anime_rcnn", "live_yolo"])
def test_cli_det_max_side_maps_to_the_resolved_detector(monkeypatch, args, det_cls,
                                                        attr, value):
    """``--det-max-side`` goes to the resolved detector's own resize
    argument: Faster R-CNN (the anime default) gets ``resize_spec=(N, N)``
    — the JAX CLI passes it ``max_side`` and raises TypeError — and YOLOv3
    ``max_side=N``."""
    served = []
    monkeypatch.setattr("videotofaces_tpu_torch.pipeline.grouping.get_encoder_model",
                        lambda style, enc, dev, **kw: FakeEncoder())
    monkeypatch.setattr(TS, "serve_forever",
                        lambda service, socket_path=None, tcp=None: served.append(
                            (service, tcp)))
    TS.main(args + ["--det-max-side", "320", "--tcp", "127.0.0.1:0", "-d", "cpu"])
    (service, tcp), = served
    assert tcp == ("127.0.0.1", 0)
    assert type(service.detector) is det_cls
    assert getattr(service.detector, attr) == value
    assert service.detector.device.type == "cpu"


def test_cli_det_max_side_refuses_mtcnn(capsys):
    with pytest.raises(SystemExit) as e:
        TS.main(["--det-model", "mtcnn", "--det-max-side", "320", "--tcp", "127.0.0.1:0",
                 "-d", "cpu"])
    assert e.value.code == 2
    assert "--det-max-side does not apply to the mtcnn detector" in capsys.readouterr().err


def test_service_device_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FaceService()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FaceService(detector=FakeDetector(), encoder=FakeEncoder())


def test_cli_serves_on_the_cpu_over_tcp():
    """``python -m videotofaces_tpu_torch.serve -d cpu --tcp 127.0.0.1:0``
    starts with the live defaults, answers a ping and a detect, and exits on
    shutdown."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "videotofaces_tpu_torch.serve", "-d", "cpu",
         "--tcp", "127.0.0.1:0", "--det-max-side", "64"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("v2f serving on "):
                break
        else:
            pytest.fail("the daemon never listened:\n" + "".join(lines))
        host, port = ast.literal_eval(line[len("v2f serving on "):])
        client = ServeClient((host, port))
        try:
            assert client.ping() is True
            res = client.detect(_frames(2, h=48, w=64))
            assert len(res) == 2 and all(b.shape[1] == 4 for b, _ in res)
            client.shutdown()
        finally:
            client.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
