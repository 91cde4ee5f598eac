"""Faults planted under the timed path for the harness's tests: each must
make ``correct`` come out false."""

import numpy as np


def altered(per_frame):
    """Every answer altered where it is produced: scores up by 0.05,
    boxes moved 2 px."""
    return [(np.asarray(b) + 2.0, np.asarray(s) + 0.05) for b, s in per_frame]


def half_left_out(per_frame):
    """The second half of the batch answered with nothing."""
    n = len(per_frame)
    return per_frame[:n - n // 2] + [(np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
                                     for _ in range(n // 2)]


def slot_offset(per_frame):
    """The boxes of the last slot of the batch moved by one pixel."""
    b, s = per_frame[-1]
    return per_frame[:-1] + [(np.asarray(b) + 1.0, s)]


DETECTOR = {"altered": altered, "half": half_left_out, "slot_offset": slot_offset}


def break_detector(monkeypatch, fault):
    """Patch both detector wrappers' ``collect`` with ``fault``."""
    from videotofaces_tpu_torch.models import wrappers as W

    box_collect, mtcnn_collect = W._BoxDetectorBase.collect, W.MtcnnDetector.collect

    def boxes(self, handle):
        b, s, c = box_collect(self, handle)
        per = fault(list(zip(b, s)))
        return [p[0] for p in per], [p[1] for p in per], c[:len(per)]

    def mtcnn(self, handle, return_landmarks=False):
        out = mtcnn_collect(self, handle)
        return [np.concatenate([np.asarray(b).reshape(-1, 4), np.asarray(s)[:, None]], 1)
                for b, s in fault([(o[:, :4], o[:, 4]) for o in out])]

    monkeypatch.setattr(W._BoxDetectorBase, "collect", boxes)
    monkeypatch.setattr(W.MtcnnDetector, "collect", mtcnn)


def break_encoder(monkeypatch, fault):
    """Patch the encoders' ``__call__``: ``"altered"`` moves every
    embedding, ``"half"`` answers the second half of each batch with the
    first half's rows."""
    from videotofaces_tpu_torch.models import wrappers as W

    call = W._Encoder.__call__

    def broken(self, images):
        x = call(self, images)
        if fault == "altered":
            return x + 0.01 * np.sign(x)
        n = len(x)
        x[n - n // 2:] = x[:n // 2]
        return x

    monkeypatch.setattr(W._Encoder, "__call__", broken)


def break_service(service, fault):
    """Patch a ``FaceService``'s ``extract`` (in the daemon process)."""
    extract = service.extract

    def broken(frames, return_crops=False):
        res = extract(frames, return_crops)
        if fault == "altered":
            for r in res:
                r["boxes"] = np.asarray(r["boxes"]) + 1
            return res
        n = len(res)
        for r in res[n - n // 2:]:
            r["boxes"] = np.zeros((0, 4), np.int64)
            r["scores"] = np.zeros(0, np.float32)
            r["embeddings"] = np.zeros((0, r["embeddings"].shape[-1]), np.float32)
        return res

    service.extract = broken
