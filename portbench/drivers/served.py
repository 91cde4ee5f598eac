"""The ``served`` mix: an open loop of ``extract`` requests to the binary
daemon of ``serve.py`` over a unix socket.

The daemon is a child process of the run (spawned, so that the run itself
holds no CUDA context while it is measured). The child makes the weights
(``models.detector_state`` / ``encoder_state``, shared back to the run as
host tensors), builds the program's ``FaceService(detector=...,
encoder=...)``, warms it (``FaceService.warmup`` for the mix's batch
buckets, then a few real requests through the socket), serves with
``serve.make_server`` and, in a traced run, profiles the device over the
window. The run sends the requests of a fixed schedule (``make_arrivals``:
the count fixed by the rate and the window, sizes from a fixed multiset),
each from a pool of connections so that no arrival waits for an earlier
response, and times each from its scheduled send time to its response.

End to end: ``request_ms_p95`` over all requests of the window (a failed
request counts as missed). ``correct``: a sample of the answered requests
drawn from the seed (the largest among them), recomputed by the reference
(detector, box rules, crops, encoder) on the same frames."""

import os.path as osp
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import judge, precision, registry, traffic
from ..reference import pipeline as RP

READY_TIMEOUT_S = 1100


def _frames(run):
    tr = run.traffic
    clip = traffic.make_clips(osp.join(run.scratch, "clips"), run.seed, tr["clip"])[0]
    return RP.read_frames(clip, tr["video_step"], tr["pool_frames"])[1]


def _calib_crops(cfg, seed, n):
    import cv2

    s = cfg["encoder"]["input_size"]
    crops, _ = traffic.crop_images(seed, {"n": n, "identities": 8, "px": [s, s], "dup_share": 0})
    return [cv2.resize(c, (s, s), interpolation=cv2.INTER_LINEAR) for c in crops]


def child_main(cfg, tr, seed, address, frames, crops, to_child, to_parent, device="cuda"):
    """The daemon process: weights, the program's service, warm-up, serving
    on ``address``; answers the run's commands on ``to_child``."""
    try:
        _child(cfg, tr, seed, address, frames, crops, to_child, to_parent, device)
    except BaseException as e:  # noqa: BLE001 - the run waits on this queue
        import traceback

        to_parent.put(("error", traceback.format_exc()))
        raise e


def _child(cfg, tr, seed, address, frames, crops, to_child, to_parent, device):
    import os

    sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))
    from portbench import harness, models

    harness.prepare_environment()
    import torch

    from videotofaces_tpu_torch import config as V2F
    from videotofaces_tpu_torch import serve as S
    from videotofaces_tpu_torch.specs import BoxCriteria

    V2F.set_precision(cfg["precision"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    det_state = models.detector_state(cfg, seed, dev,
                                       frames[:cfg["detector"]["calibration_frames"]])[0]
    enc_state = models.encoder_state(cfg, seed, dev, crops)
    for st in (det_state, enc_state):
        for t in st.values():
            t.share_memory_()
    to_parent.put(("states", det_state, enc_state))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    det = models.program_detector(cfg, det_state, dev)
    enc = models.program_encoder(cfg, enc_state, dev)
    service = S.FaceService(detector=det, encoder=enc, device=dev,
                            criteria=BoxCriteria(**tr["criteria"]), max_batch=tr["max_batch"])
    service.warmup(resolutions=(tuple(frames[0].shape[:2]),), batches=tr["warm"]["batches"],
                   embed_batches=tr["warm"]["embed_batches"])
    if tr.get("test_fault"):        # the harness's own tests break the daemon on purpose
        from portbench.tests import faults

        faults.break_service(service, tr["test_fault"])
    from portbench.spans import SpanRecorder

    spans = SpanRecorder()
    extract = service.extract

    def traced_extract(frames, return_crops=False):
        with spans.stage("serve:extract"):
            return extract(frames, return_crops)

    service.extract = traced_extract
    srv = S.make_server(service, address)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    client = S.ServeClient(address)
    for n in tr["warm"]["batches"]:     # the socket path and every stage, with real frames
        client.extract(frames[:n])
    client.close()
    spans.clear()
    to_parent.put(("ready", os.getpid()))
    trace = None
    while True:
        cmd = to_child.get()
        if cmd == "trace_start":
            from portbench.devtrace import DeviceTrace

            spans.clear()
            trace = DeviceTrace()
            trace.__enter__()
            to_parent.put(("tracing",))
        elif cmd == "trace_stop":
            trace.__exit__(None, None, None)
            to_parent.put(("trace", {"busy_s": trace.busy_s(), "window_s": trace.window_s(),
                                     "idle_share": trace.idle_share(),
                                     "breakdown": trace.breakdown(spans)}))
            trace = None
        elif cmd == "peak":
            if cuda:
                torch.cuda.synchronize()
            to_parent.put(("peak", torch.cuda.max_memory_allocated() if cuda else 0,
                           dict(service.stats)))
        elif cmd == "stop":
            srv.shutdown()
            srv.server_close()
            server.join(timeout=30)
            to_parent.put(("stopped",))
            return


def _expect(run, kind, timeout):
    msg = run.state["to_parent"].get(timeout=timeout)
    if msg[0] == "error":
        raise RuntimeError("the daemon failed:\n" + msg[1])
    if msg[0] != kind:
        raise RuntimeError("the daemon answered %r, expected %r" % (msg[0], kind))
    return msg


def setup(run):
    import torch.multiprocessing as mp

    run.state["remote"] = True
    cfg, tr = run.config, run.traffic
    frames = _frames(run)
    run.state["frames"] = frames
    times, counts = traffic.make_arrivals(run.seed, tr["rate"], run.seconds, tr["sizes"])
    rng = np.random.default_rng([run.seed, 1])
    run.state["requests"] = [(float(t), rng.choice(len(frames), int(n), replace=False))
                             for t, n in zip(times, counts)]
    ctx = mp.get_context("spawn")
    run.state["to_child"], run.state["to_parent"] = ctx.Queue(), ctx.Queue()
    address = osp.join(run.scratch, "s")      # a unix socket path has at most 107 bytes
    run.state["address"] = address
    child = ctx.Process(target=child_main, name="portbench-daemon", args=(
        cfg, tr, run.seed, address, frames[:cfg["detector"]["calibration_frames"]],
        _calib_crops(cfg, run.seed, tr["calibration_crops"]), run.state["to_child"],
        run.state["to_parent"], run.state.get("device", "cuda")))
    child.start()
    run.state["child"] = child
    _, det_state, enc_state = _expect(run, "states", READY_TIMEOUT_S)
    run.state["det_state"], run.state["enc_state"] = det_state, enc_state
    _expect(run, "ready", READY_TIMEOUT_S)
    from videotofaces_tpu_torch.serve import ServeClient

    run.state["client_cls"] = ServeClient


class _Trace:
    """The daemon's device trace summary, read by the per-layer readers
    and the result line as the run's own trace is."""

    def __init__(self, d):
        self.d = d

    def busy_s(self):
        return self.d["busy_s"]

    def window_s(self):
        return self.d["window_s"]

    def idle_share(self):
        return self.d["idle_share"]

    def breakdown(self, spans):
        return self.d["breakdown"]


def window(run):
    tr = run.traffic
    frames = run.state["frames"]
    client_cls, address = run.state["client_cls"], run.state["address"]
    local = threading.local()
    clients = []
    lock = threading.Lock()

    def client():
        c = getattr(local, "c", None)
        if c is None:
            c = local.c = client_cls(address)
            with lock:
                clients.append(c)
        return c

    def send(i, due, picks):
        try:
            res = client().extract([frames[k] for k in picks])
            return i, due, time.perf_counter(), res
        except Exception as e:  # noqa: BLE001 - a failed request counts as missed
            return i, due, time.perf_counter(), e

    if run.traced:
        run.state["to_child"].put("trace_start")
        _expect(run, "tracing", 60)
    reqs = run.state["requests"]
    late = []
    futures = []
    with ThreadPoolExecutor(tr["clients"]) as pool:
        t0 = time.perf_counter()
        for i, (t, picks) in enumerate(reqs):
            due = t0 + t
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - due)
            futures.append(pool.submit(send, i, due, picks))
        results = [f.result() for f in futures]
    t1 = time.perf_counter()
    for c in clients:
        c.close()
    if run.traced:
        run.state["to_child"].put("trace_stop")
        run.trace = _Trace(_expect(run, "trace", 600)[1])
    lat = np.array([(done - due) * 1e3 if not isinstance(res, Exception) else np.inf
                    for _, due, done, res in results])
    run.failed = int(np.isinf(lat).sum())
    run.attempted = len(reqs)
    run.state["responses"] = {i: res for i, _, _, res in results if not isinstance(res, Exception)}
    run.state["latencies_ms"] = lat
    run.counts.update(requests=len(reqs), late_ms_max=1e3 * max(late, default=0.0),
                      late_ms_p50=1e3 * float(np.median(late)) if late else 0.0,
                      window_s=t1 - t0)
    errors = [repr(res) for _, _, _, res in results if isinstance(res, Exception)]
    if errors:
        print("portbench: %d requests failed, first: %s" % (len(errors), errors[0]),
              file=sys.stderr)
    quarters = [float(np.median(q)) for q in np.array_split(lat, 4) if len(q)]
    print("portbench: %d requests in %.3f s, sender late by at most %.3f ms (median %.3f); "
          "median ms by quarter of the schedule %s"
          % (len(reqs), t1 - t0, run.counts["late_ms_max"], run.counts["late_ms_p50"],
             ["%.1f" % q for q in quarters]), file=sys.stderr)
    run.e2e["request_ms_p95"] = float(np.percentile(lat, 95))


def memory_peak(run):
    run.state["to_child"].put("peak")
    _, peak, stats = _expect(run, "peak", 120)
    run.state["service_stats"] = stats
    return peak


def release(run):
    _stop_child(run)


def _stop_child(run):
    child = run.state.pop("child", None)
    if child is None:
        return
    if child.is_alive():
        run.state["to_child"].put("stop")
        try:
            _expect(run, "stopped", 60)
        except (queue.Empty, RuntimeError):
            pass
    child.join(timeout=60)
    if child.is_alive():
        child.kill()
        child.join(timeout=30)


def check(run):
    import torch

    from .. import models, seeding

    cfg, tr = run.config, run.traffic
    dev = torch.device(run.state.get("device", "cuda"))
    answered = sorted(run.state["responses"])
    rng = np.random.default_rng([run.seed, 2])
    sample = []
    if answered:
        largest = max(answered, key=lambda i: len(run.state["requests"][i][1]))
        rest = [i for i in answered if i != largest]
        sample = [largest] + [int(i) for i in rng.choice(
            rest, min(len(rest), tr["check_requests"] - 1), replace=False)]
    det = models.reference_detector(cfg).to(dev).eval()
    seeding.load_state_(det, run.state["det_state"])
    enc = models.reference_encoder(cfg).to(dev).eval()
    seeding.load_state_(enc, run.state["enc_state"])
    run.state["reference"] = (det, enc)
    run.state["sample"] = sample
    run.state["ref_answers"] = {i: _reference_extract(run, i) for i in sample}
    values = _values(run, {i: run.state["responses"][i] for i in sample})
    print("portbench: checked %d requests, %d faces" % (
        len(sample), sum(len(f["boxes"]) for a in run.state["ref_answers"].values() for f in a)),
        file=sys.stderr)
    return judge.compare(values, registry.limits(run.name))


def _reference_extract(run, i):
    """The reference's answer to request ``i``: per frame the adjusted boxes
    that pass the box rules and their embeddings."""
    from .. import models

    cfg, tr = run.config, run.traffic
    det, enc = run.state["reference"]
    fr = [run.state["frames"][k] for k in run.state["requests"][i][1]]
    out = []
    for frame, (boxes, scores) in zip(fr, models.reference_detect(cfg, det, fr, len(fr))):
        want = _extract_frame(frame, boxes, scores, tr["criteria"])
        out.append({"boxes": np.asarray([b for b, _ in want], np.int64).reshape(-1, 4),
                    "embeddings": (models.reference_embed(cfg, enc, [c for _, c in want])
                                   if want else np.zeros((0, 1), np.float32))})
    return out


def _values(run, answers):
    """The numbers of ``answers`` ({request: per-frame dicts}) against the
    reference's answers to the same requests."""
    face_bad = face_all = 0
    emb_gap = 0.0
    for i, got_frames in answers.items():
        for got, want in zip(got_frames, run.state["ref_answers"][i], strict=True):
            got_boxes = [tuple(b) for b in np.asarray(got["boxes"]).reshape(-1, 4).tolist()]
            want_boxes = [tuple(b) for b in want["boxes"].tolist()]
            face_all += len(set(got_boxes) | set(want_boxes))
            face_bad += len(set(got_boxes) ^ set(want_boxes))
            for j, b in enumerate(got_boxes):
                if b in want_boxes:
                    k = want_boxes.index(b)
                    emb_gap = max(emb_gap, judge.embeddings(got["embeddings"][j:j + 1],
                                                            want["embeddings"][k:k + 1]))
    return {"face_mismatch_share": face_bad / face_all if face_all else 0.0,
            "emb_gap_max": emb_gap,
            "unanswered_share": run.failed / max(run.attempted, 1)}


def control(run):
    """The numbers with the reference in TF32 in the program's place, on
    the checked requests (after ``check``)."""
    det, enc = run.state["reference"]
    with precision.tf32(det), precision.tf32(enc):
        low = {i: _reference_extract(run, i) for i in run.state["sample"]}
    return _values(run, low)


def _extract_frame(frame, boxes, scores, criteria):
    """The reference's extract of one frame: [(adjusted box, crop)]."""
    hw = frame.shape[:2]
    ib = RP.round_out(boxes)
    ok = RP.passes(ib, scores, hw, criteria["min_score"], criteria["min_size"],
                   criteria["min_border"])
    out = []
    for box in ib[ok]:
        x1, y1, x2, y2 = RP.adjust_box(box, hw, criteria["scale"], criteria["square"])
        crop = frame[y1:y2, x1:x2]
        if crop.size:
            out.append(((x1, y1, x2, y2), crop))
    return out


def work(run):
    lat = run.state["latencies_ms"]
    run.work["request_ms_p50"] = float(np.percentile(lat, 50))
    faces = sum(len(np.asarray(f["boxes"]).reshape(-1, 4)) for res in
                run.state["responses"].values() for f in res)
    run.work["faces_per_request"] = faces / max(len(run.state["responses"]), 1)


def close(run):
    _stop_child(run)
    run.state.pop("reference", None)
