"""Serving: a long-lived face-extraction service that owns the card
(counterpart of videotofaces_tpu/serve.py).

A batch CLI pays model load, the CUDA context and the first call of every
shape on each run; a resident process pays them once and answers requests.
Two layers:

- ``FaceService``: the in-process engine. Holds detector + encoder wrappers,
  rounds request sizes onto a small set of power-of-two batch buckets so an
  arbitrary stream of requests runs a bounded set of padded batch shapes,
  and offers ``warmup()`` to pay the first call of each before the first
  request. ``extract()`` is the full detect -> filter/adjust -> crop ->
  embed step — the serving analogue of one pipeline iteration
  (pipeline/detection.py).
- a socket daemon (``serve_forever`` / ``ServeClient``) speaking a
  length-prefixed binary protocol: JSON header + raw ndarray payload, no
  third-party dependencies; transports are a Unix domain socket (local) or
  TCP (remote clients), same framing on both. The protocol is byte for byte
  the JAX package's: a client of either package talks to a server of the
  other. Requests are served FIFO under one lock; every model call runs
  under its own thread's precision (``config.model_call``).

Run:  python -m videotofaces_tpu_torch.serve --socket /tmp/v2f.sock --style live
      python -m videotofaces_tpu_torch.serve --tcp 7433 --style live
      python -m videotofaces_tpu_torch.serve --http 8080 --style live -d cpu

Without ``-d`` the service runs on the card and raises when there is none.
The HTTP gateway speaks JSON with base64 JPEG/PNG images (curl-friendly);
the binary protocol is the efficient path for raw frames. Neither network
transport authenticates callers (shutdown/compute are open to anyone who
can connect) — the CLI binds 127.0.0.1 unless an explicit host is given;
front external exposure with a real gateway or firewall.
"""

import json
import os
import socket
import socketserver
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import config
from .pipeline import boxfilter as BF
from .specs import BoxCriteria

MAGIC = b"V2F1"


def _bucket(n, cap):
    """Smallest power of two >= n, capped. On the card a bucket bounds the
    set of padded batch shapes a stream of requests runs: the shapes cuDNN
    and cuBLAS choose algorithms for at their first call, and the sizes of
    the pinned host blocks the caching allocator keeps. PyTorch compiles
    nothing per shape, so there is no jit cache to bound; the detectors'
    per-frame-size caches (geometry and priors) follow the frame size."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


class FaceService:
    """Resident detector + encoder with bucketed batch shapes.

    ``style``/``det_model``/``enc_model`` follow the pipeline factories
    (pipeline/detection.get_detector_model, pipeline/grouping.get_encoder_model),
    ``det_kw``/``enc_kw`` go to them; ``criteria`` is the box accept/adjust
    rule set applied by ``extract``. ``device``: None means the card and
    raises when there is none; ``"cpu"`` runs on the CPU. ``mesh``: as the
    factories take it — a ``parallel.Mesh`` shards both models over its
    devices, ``"auto"`` and None keep one device. ``detector`` /
    ``encoder`` replace the factories' models.
    """

    def __init__(self, style="live", det_model="default", enc_model="default",
                 criteria=None, max_batch=32, mesh="auto", det_kw=None, enc_kw=None,
                 detector=None, encoder=None, *, device=None):
        from .pipeline.mesh_auto import resolve_mesh

        self.criteria = criteria or BoxCriteria()
        self.max_batch = max_batch
        mesh = resolve_mesh(mesh)
        self.device = config.resolve_device(device) if mesh is None else mesh.devices[0]
        if detector is None:
            from .pipeline.detection import get_detector_model

            detector = get_detector_model(style, det_model, device, mesh=mesh,
                                          **(det_kw or {}))
        if encoder is None:
            from .pipeline.grouping import get_encoder_model

            encoder = get_encoder_model(style, enc_model, device, mesh=mesh,
                                        **(enc_kw or {}))
        self.detector = detector
        self.encoder = encoder
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "frames": 0, "faces": 0, "crops_embedded": 0}

    # -- engine ------------------------------------------------------------

    def _detect_batch(self, frames):
        """Frames (same H, W) -> list of (boxes [n,4] f32, scores [n] f32)."""
        out = []
        for i in range(0, len(frames), self.max_batch):
            chunk = frames[i:i + self.max_batch]
            self.detector.batch_size = _bucket(len(chunk), self.max_batch)
            detout = self.detector(chunk)
            if isinstance(detout, tuple):     # yolo / rcnn: (boxes, scores, classes)
                out += list(zip(detout[0], detout[1]))
            else:                             # mtcnn: list of [n, 5]
                out += [(d[:, :4], d[:, 4]) for d in detout]
        return out

    def _embed_chunks(self, crops):
        out = []
        for i in range(0, len(crops), self.max_batch):
            chunk = list(crops[i:i + self.max_batch])
            self.encoder.batch_size = _bucket(len(chunk), self.max_batch)
            out.append(self.encoder(chunk))
        return np.concatenate(out, axis=0)

    def detect(self, frames):
        """BGR uint8 frames (equal shape) -> per-frame (boxes, scores)."""
        with self._lock:
            self.stats["requests"] += 1
            self.stats["frames"] += len(frames)
            return self._detect_batch(list(frames))

    def embed(self, crops):
        """BGR uint8 face crops (any sizes) -> [len(crops), D] embeddings."""
        with self._lock:
            self.stats["requests"] += 1
            out = self._embed_chunks(crops)
            self.stats["crops_embedded"] += len(crops)
            return out

    def extract(self, frames, return_crops=False):
        """Full step per frame: detect -> criteria filter -> adjust/square ->
        crop -> embed. Returns a list of dicts with keys ``boxes`` (adjusted
        int crops that passed, [m, 4]), ``scores`` [m], ``embeddings`` [m, D]
        and optionally ``crops`` (list of BGR arrays)."""
        with self._lock:
            self.stats["requests"] += 1
            self.stats["frames"] += len(frames)
            det = self._detect_batch(list(frames))
            img_size = frames[0].shape[:2]
            c = self.criteria
            results, all_crops, owners = [], [], []
            for fi, (frame, (raw_boxes, raw_scores)) in enumerate(zip(frames, det)):
                iboxes = BF.round_out(np.asarray(raw_boxes, dtype=np.float32))
                scores = np.asarray(raw_scores, dtype=np.float32)
                c1, c2, c3 = BF.check_conditions(iboxes, scores, img_size,
                                                 c.min_score, c.min_size, c.min_border)
                keep = ~(c1 | c2 | c3)
                adjusted = BF.adjust_boxes(iboxes[keep], img_size, c.scale, c.square)
                kept_boxes, kept_scores = [], []
                for box, score in zip(adjusted, scores[keep]):
                    x1, y1, x2, y2 = box
                    crop = frame[y1:y2, x1:x2]
                    if crop.size == 0:
                        continue
                    kept_boxes.append(box)
                    kept_scores.append(score)
                    all_crops.append(crop)
                    owners.append(fi)
                results.append({
                    "boxes": (np.stack(kept_boxes) if kept_boxes
                              else np.zeros((0, 4), np.int64)),
                    "scores": np.asarray(kept_scores, dtype=np.float32),
                })

            embs = (self._embed_chunks(all_crops) if all_crops
                    else np.zeros((0, 1), np.float32))
            owners = np.asarray(owners, dtype=np.int64)
            for fi, res in enumerate(results):
                sel = owners == fi
                res["embeddings"] = embs[sel]
                if return_crops:
                    res["crops"] = [cr for cr, o in zip(all_crops, owners) if o == fi]
            self.stats["faces"] += len(all_crops)
            self.stats["crops_embedded"] += len(all_crops)
            return results

    def warmup(self, resolutions=((1080, 1920),), batches=(4,), embed_batches=(16,)):
        """Pay the first-call costs up front: one dummy run per (batch
        bucket, resolution) of the detector and per encoder batch bucket.

        On the card that pays, before the first request: the build of
        every kernel source (``ops/_cuda.build_all``, one ``nvcc`` per
        source in parallel; a built library is reused from ``build/``),
        the CUDA context and the cuBLAS / cuDNN handles, cuDNN's and
        cuBLAS's algorithm choice for each padded batch shape, the
        detector's per-frame-size geometry and priors, and the pinned host
        blocks of each batch shape. A data-dependent stage that blank
        frames do not reach (MTCNN's later stages, with no candidates) pays
        its first call at the first request that reaches it. A sharded
        model rounds every batch up to its mesh's size, so each warm-up
        call runs every replica."""
        with self._lock:
            if self.device.type == "cuda":
                from .ops import _cuda

                _cuda.build_all()
            for (h, w) in resolutions:
                for b in batches:
                    bb = _bucket(b, self.max_batch)
                    self.detector.batch_size = bb
                    self.detector([np.zeros((h, w, 3), np.uint8)] * bb)
            s = self.encoder.input_size
            for b in embed_batches:
                bb = _bucket(b, self.max_batch)
                self.encoder.batch_size = bb
                self.encoder([np.zeros((s, s, 3), np.uint8)] * bb)


# -- wire protocol ---------------------------------------------------------
#
# frame := MAGIC | u32 header_len | header_json | u64 payload_len | payload
# Arrays travel in the payload as raw C-order bytes; the header describes
# them as {"arrays": [{"dtype": ..., "shape": [...]}, ...]} in order.


def _send_frame(sock, header, arrays=()):
    header = dict(header)
    header["arrays"] = [{"dtype": str(a.dtype), "shape": list(a.shape)}
                        for a in arrays]
    hj = json.dumps(header).encode()
    payload = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    sock.sendall(MAGIC + struct.pack("<I", len(hj)) + hj
                 + struct.pack("<Q", len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock):
    head = sock.recv(8)
    if not head:
        return None, None          # clean EOF between frames
    head += _recv_exact(sock, 8 - len(head)) if len(head) < 8 else b""
    if head[:4] != MAGIC:
        raise ConnectionError("bad magic %r" % head[:4])
    (hlen,) = struct.unpack("<I", head[4:8])
    header = json.loads(_recv_exact(sock, hlen))
    (plen,) = struct.unpack("<Q", _recv_exact(sock, 8))
    payload = _recv_exact(sock, plen)
    arrays, off = [], 0
    for spec in header.get("arrays", ()):
        a = np.frombuffer(payload, dtype=np.dtype(spec["dtype"]),
                          count=int(np.prod(spec["shape"]) or 0), offset=off)
        arrays.append(a.reshape(spec["shape"]))
        off += a.nbytes
    return header, arrays


def _ragged_out(pairs_or_dicts, keys):
    """Per-frame ragged results -> (header counts, flat arrays) for the wire."""
    arrays, counts = [], []
    for item in pairs_or_dicts:
        counts.append(int(len(item[keys[0]])))
    for k in keys:
        # Skip zero-count frames: reshape(0, -1) raises on empty arrays, and
        # they contribute no rows anyway (mixed empty/non-empty batches are
        # the common case).
        parts = [np.asarray(item[k]).reshape(len(item[k]), -1)
                 for item in pairs_or_dicts if len(item[k])]
        arrays.append(np.concatenate(parts, axis=0) if parts
                      else np.zeros((0, 1), np.float32))
    return counts, arrays


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        service = self.server.service
        while True:
            try:
                header, arrays = _recv_frame(self.request)
            except ConnectionError:
                return
            if header is None:
                return
            try:
                self._dispatch(service, header, arrays)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                _send_frame(self.request, {"ok": False, "error": repr(e)})

    def _dispatch(self, service, header, arrays):
        op = header.get("op")
        if op == "ping":
            _send_frame(self.request, {"ok": True, "pong": True})
        elif op == "stats":
            _send_frame(self.request, {"ok": True, "stats": service.stats})
        elif op == "warmup":
            service.warmup(
                resolutions=[tuple(r) for r in header.get("resolutions", [[1080, 1920]])],
                batches=header.get("batches", [4]),
                embed_batches=header.get("embed_batches", [16]))
            _send_frame(self.request, {"ok": True})
        elif op == "detect":
            frames = list(arrays[0])
            res = service.detect(frames)
            dicts = [{"boxes": b, "scores": s} for b, s in res]
            counts, (boxes, scores) = _ragged_out(dicts, ["boxes", "scores"])
            _send_frame(self.request, {"ok": True, "counts": counts},
                        [boxes.astype(np.float32), scores.astype(np.float32)])
        elif op == "embed":
            sizes = header["sizes"]
            flat, off, crops = arrays[0], 0, []
            for (h, w) in sizes:
                n = h * w * 3
                crops.append(flat[off:off + n].reshape(h, w, 3))
                off += n
            emb = service.embed(crops)
            _send_frame(self.request, {"ok": True}, [emb.astype(np.float32)])
        elif op == "extract":
            res = service.extract(list(arrays[0]))
            counts, (boxes, scores, emb) = _ragged_out(
                res, ["boxes", "scores", "embeddings"])
            _send_frame(self.request, {"ok": True, "counts": counts},
                        [boxes.astype(np.int64), scores.astype(np.float32),
                         emb.astype(np.float32)])
        elif op == "shutdown":
            _send_frame(self.request, {"ok": True})
            threading.Thread(target=self.server.shutdown, daemon=True).start()
        else:
            _send_frame(self.request, {"ok": False, "error": "unknown op %r" % op})


class _Server(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _TcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def make_server(service, address):
    """Build a (not yet running) daemon server.

    ``address``: a unix-socket path (str) or a ``(host, port)`` tuple — the
    wire protocol is identical on both transports. With port 0 the OS picks
    a free port; read it back from ``server.server_address``.
    """
    if address is None:
        raise ValueError("no listen address: pass a unix socket path or a "
                         "(host, port) tuple")
    if isinstance(address, tuple):
        srv = _TcpServer(address, _Handler)
    else:
        if os.path.exists(address):
            os.unlink(address)
        srv = _Server(address, _Handler)
    srv.service = service
    return srv


def serve_forever(service, socket_path=None, tcp=None):
    """Blocking daemon loop; returns when a client sends ``shutdown``.

    ``socket_path``: unix socket to listen on, or ``tcp=(host, port)`` for
    the TCP transport (same framed protocol).
    """
    address = tcp if tcp is not None else socket_path
    with make_server(service, address) as srv:
        print("v2f serving on %s" % (srv.server_address,), flush=True)
        srv.serve_forever()
    if isinstance(address, str) and os.path.exists(address):
        os.unlink(address)


class _HttpHandler(BaseHTTPRequestHandler):
    """JSON/HTTP gateway over the same FaceService.

    Images travel as base64-encoded JPEG/PNG (``cv2.imencode`` on the
    client, decoded server-side) — curl-friendly, no custom framing:

      GET  /ping /stats
      POST /detect  {"frames": [b64, ...]}
           -> {"results": [{"boxes": [[x1,y1,x2,y2]..], "scores": [..]}..]}
      POST /embed   {"crops": [b64, ...]} -> {"embeddings": [[...]..]}
      POST /extract {"frames": [b64, ...]}
           -> per frame boxes/scores/embeddings
      POST /shutdown
    """

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # no per-request stderr spam
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _decode_images(self, items):
        import base64

        import cv2

        out = []
        for s in items:
            buf = np.frombuffer(base64.b64decode(s), np.uint8)
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError("undecodable image payload")
            out.append(img)
        return out

    def do_GET(self):
        service = self.server.service
        if self.path == "/ping":
            self._json(200, {"ok": True, "pong": True})
        elif self.path == "/stats":
            self._json(200, {"ok": True, "stats": dict(service.stats)})
        else:
            self._json(404, {"ok": False, "error": "unknown path %r" % self.path})

    def do_POST(self):
        service = self.server.service
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/detect":
                res = service.detect(self._decode_images(req["frames"]))
                self._json(200, {"ok": True, "results": [
                    {"boxes": np.asarray(b).tolist(),
                     "scores": np.asarray(s).tolist()} for b, s in res]})
            elif self.path == "/embed":
                emb = service.embed(self._decode_images(req["crops"]))
                self._json(200, {"ok": True,
                                 "embeddings": np.asarray(emb).tolist()})
            elif self.path == "/extract":
                res = service.extract(self._decode_images(req["frames"]))
                self._json(200, {"ok": True, "results": [
                    {"boxes": np.asarray(r["boxes"]).tolist(),
                     "scores": np.asarray(r["scores"]).tolist(),
                     "embeddings": np.asarray(r["embeddings"]).tolist()}
                    for r in res]})
            elif self.path == "/warmup":
                service.warmup(**{k: [tuple(v) if isinstance(v, list) else v
                                      for v in vals]
                                  for k, vals in req.items()})
                self._json(200, {"ok": True})
            elif self.path == "/shutdown":
                self._json(200, {"ok": True})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
            else:
                self._json(404, {"ok": False,
                                 "error": "unknown path %r" % self.path})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            self._json(400, {"ok": False, "error": repr(e)})


class _HttpServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def make_http_server(service, address):
    """HTTP/JSON gateway server on ``(host, port)`` (port 0 = OS-picked)."""
    srv = _HttpServer(address, _HttpHandler)
    srv.service = service
    return srv


class ServeClient:
    """Client for the daemon; mirrors the FaceService methods.

    ``address``: unix-socket path (str) or ``(host, port)`` tuple for TCP.
    """

    def __init__(self, address):
        if isinstance(address, tuple):
            self.sock = socket.create_connection(address)
        else:
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.connect(address)

    def close(self):
        self.sock.close()

    def _rpc(self, header, arrays=()):
        _send_frame(self.sock, header, arrays)
        rheader, rarrays = _recv_frame(self.sock)
        if rheader is None:
            raise ConnectionError("server closed connection")
        if not rheader.get("ok"):
            raise RuntimeError("server error: %s" % rheader.get("error"))
        return rheader, rarrays

    def ping(self):
        return self._rpc({"op": "ping"})[0]["pong"]

    def stats(self):
        return self._rpc({"op": "stats"})[0]["stats"]

    def warmup(self, resolutions=((1080, 1920),), batches=(4,), embed_batches=(16,)):
        self._rpc({"op": "warmup", "resolutions": [list(r) for r in resolutions],
                   "batches": list(batches), "embed_batches": list(embed_batches)})

    def shutdown(self):
        self._rpc({"op": "shutdown"})

    def detect(self, frames):
        arr = np.stack(frames).astype(np.uint8)
        header, (boxes, scores) = self._rpc({"op": "detect"}, [arr])
        return self._split(header["counts"], boxes.reshape(-1, 4), scores.ravel())

    def embed(self, crops):
        sizes = [list(c.shape[:2]) for c in crops]
        flat = np.concatenate([np.ascontiguousarray(c, dtype=np.uint8).ravel()
                               for c in crops])
        _, (emb,) = self._rpc({"op": "embed", "sizes": sizes}, [flat])
        return emb

    def extract(self, frames):
        arr = np.stack(frames).astype(np.uint8)
        header, (boxes, scores, emb) = self._rpc({"op": "extract"}, [arr])
        counts = header["counts"]
        bs = self._split(counts, boxes.reshape(-1, 4), scores.ravel())
        embs = self._split(counts, emb.reshape(-1, emb.shape[-1]))
        return [{"boxes": b, "scores": s, "embeddings": e}
                for (b, s), (e,) in zip(bs, embs)]

    @staticmethod
    def _split(counts, *flats):
        out, off = [], 0
        for n in counts:
            out.append(tuple(f[off:off + n] for f in flats))
            off += n
        return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="videotofaces_tpu_torch.serve")
    p.add_argument("--socket", help="unix socket path to listen on")
    p.add_argument("--tcp", metavar="HOST:PORT",
                   help="TCP address to listen on instead of a unix socket")
    p.add_argument("--http", metavar="HOST:PORT",
                   help="serve the JSON/HTTP gateway instead of the binary protocol")
    p.add_argument("--style", default="live", choices=["live", "anime"])
    p.add_argument("--det-model", default="default")
    p.add_argument("--enc-model", default="default")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--det-max-side", type=int, default=None,
                   help="detector resize target (yolo: longer side; rcnn: both "
                        "sides of its resize spec); smaller = faster")
    p.add_argument("--warmup-res", type=int, nargs=2, action="append",
                   help="HEIGHT WIDTH resolution to warm up (repeatable)")
    p.add_argument("-d", "--device",
                   help='"cuda" (the default) or "cpu"; without a CUDA device pass "cpu"')
    args = p.parse_args(argv)
    if sum(map(bool, (args.socket, args.tcp, args.http))) != 1:
        p.error("exactly one of --socket / --tcp / --http is required")
    from .pipeline.detection import resolve_det_model

    try:
        det = resolve_det_model(args.style, args.det_model)
    except ValueError as e:
        p.error(str(e))
    det_kw = {}
    if args.det_max_side:
        # each detector's own resize argument; the MTCNN cascade has none
        if det == "mtcnn":
            p.error("--det-max-side does not apply to the mtcnn detector")
        n = args.det_max_side
        det_kw = {"max_side": n} if det == "yolo" else {"resize_spec": (n, n)}
    service = FaceService(style=args.style, det_model=det, enc_model=args.enc_model,
                          max_batch=args.max_batch, device=args.device, det_kw=det_kw)
    if args.warmup_res:
        service.warmup(resolutions=[tuple(r) for r in args.warmup_res])
    if args.http:
        host, _, port = args.http.rpartition(":")
        with make_http_server(service, (host or "127.0.0.1", int(port))) as srv:
            print("v2f http gateway on %s" % (srv.server_address,), flush=True)
            srv.serve_forever()
    elif args.tcp:
        host, _, port = args.tcp.rpartition(":")
        serve_forever(service, tcp=(host or "127.0.0.1", int(port)))
    else:
        serve_forever(service, args.socket)
    # A handler thread that is still ending while the interpreter finalizes
    # can abort the process ("terminate called without an active exception",
    # seen in about half the CPU runs after a model call in a handler):
    # let them end first, within a bound, so that a client that keeps its
    # connection open cannot hold the process.
    deadline = time.monotonic() + 10.0
    for t in threading.enumerate():
        if t is not threading.current_thread():
            t.join(max(0.0, deadline - time.monotonic()))


if __name__ == "__main__":
    main()
