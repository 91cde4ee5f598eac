"""The detector loop's schedule (``pipeline/detection.py::process_stream``):
batches are submitted in the order they land and collected in clip order,
and the decode sources' ``take`` (``hostio/video.py``) hands each batch over
once, tagged with its position in the clip.

The file imports neither JAX nor the JAX package.
"""

import cv2
import numpy as np
import pytest
import torch

from videotofaces_tpu_torch import specs
from videotofaces_tpu_torch.hostio import video as V
from videotofaces_tpu_torch.pipeline.detection import process_stream, process_video
from videotofaces_tpu_torch.utils import profiling as P

CRITERIA = specs.BoxCriteria(batch_size=2, min_size=10)
HASH_THR = 8
# 12 batches of 2 frames in 3 segments (0-3, 4-7, 8-11); each group lands
# when the loop would otherwise wait, the segments' heads first
SCRIPT = [[4, 8], [5, 9], [0, 6, 10], [1, 7, 11], [2], [3]]


def _frames(n=24, seed=0):
    """``n`` 96x128 frames drawn from 2 images, so the window dedup drops
    crops; frame k carries k in its first pixel."""
    bases = np.random.default_rng(seed).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    frames = [bases[k % 2].copy() for k in range(n)]
    for k, f in enumerate(frames):
        f[0, 0] = k
    return frames


class _Scripted(V._SegmentSource):
    """``frames`` in batches and segments as a decode source cuts them, with
    no decode threads: each time ``take`` would wait, the next group of
    ``script`` (clip positions) lands. Logs every take as (in_order,
    position)."""

    def __init__(self, frames, workers, script):
        self.frames = frames
        self.script = iter(script)
        self.takes = []
        super().__init__(list(range(len(frames))), 1, CRITERIA.batch_size, None, workers,
                         depth=len(frames))

    def _work(self, j):
        pass

    def _wait(self):
        for pos in next(self.script):
            j = max(k for k, s in enumerate(self._starts) if s <= pos)
            # a worker lands its segment's batches in order
            assert pos == self._starts[j] + self._given[j] + len(self._held[j])
            bi = self.batches[pos]
            self._held[j].append((bi, np.stack([self.frames[i] for i in bi])))

    def take(self, in_order=False):
        item = super().take(in_order)
        self.takes.append((in_order, None if item is None else item[0]))
        return item


class _Logged:
    """A detector that logs the batches (by the frames' numbers) it is
    given and collects, and finds two boxes in every frame."""

    batch_size = None
    device = torch.device("cpu")

    def __init__(self):
        self.log = []

    def submit(self, frames):
        ids = [int(f[0, 0, 0]) for f in frames]
        self.log.append(("submit", ids[0] // CRITERIA.batch_size))
        return ids

    def collect(self, ids):
        self.log.append(("collect", ids[0] // CRITERIA.batch_size))
        return [np.array([[30, 20, 80, 70, 0.9],
                          [10 + 20 * (k % 4), 40, 50 + 20 * (k % 4), 90, 0.8]], np.float32)
                for k in ids]


def _stream(root, source, det):
    layout = specs.OutputLayout(root=str(root))
    layout.prepare_dirs(True)
    crops = {}
    names, hashes = process_stream(source, 2 * len(source), det, CRITERIA, layout, HASH_THR,
                                   P.StageTimer(), crops)
    return names, hashes, crops


def _same_faces(a, b):
    (names_a, hashes_a, crops_a), (names_b, hashes_b, crops_b) = a, b
    assert names_a == names_b and hashes_a == hashes_b
    assert crops_a.keys() == crops_b.keys()
    for k in crops_a:
        np.testing.assert_array_equal(crops_a[k], crops_b[k])


def _ahead(submits):
    """The submits made while an earlier position was still unsubmitted."""
    return sum(p > min(set(range(len(submits))) - set(submits[:k]))
               for k, p in enumerate(submits))


@pytest.mark.parametrize("depth, submits, in_order", [
    # the bound is reached only once segment 0 lags: the loop then waits
    # for batches 2 and 3
    (8, [4, 8, 5, 9, 0, 6, 10, 1, 7, 11, 2, 3], [2, 3]),
    # at the bound with batches 5, 6, 9 and 10 landed, the loop waits for
    # 0, 1, 2 and 3 in turn, collecting each
    (2, [4, 8, 0, 1, 2, 3, 5, 6, 7, 9, 10, 11], [0, 1, 2, 3]),
])
def test_submits_as_batches_land_and_collects_in_clip_order(tmp_path, monkeypatch, depth,
                                                             submits, in_order):
    monkeypatch.setenv("V2F_PIPELINE_DEPTH", str(depth))
    frames = _frames()
    src, det = _Scripted(frames, 3, SCRIPT), _Logged()
    landing = _stream(tmp_path / "landing", src, det)
    assert [b for op, b in det.log if op == "submit"] == submits
    if depth >= len(src):
        # no bound in the way: the submits follow the landing order
        assert submits == [p for group in SCRIPT for p in sorted(group)]
    assert [b for op, b in det.log if op == "collect"] == list(range(12))
    assert [pos for flag, pos in src.takes if flag] == in_order
    assert src.ahead == _ahead(submits) > 0
    held = np.cumsum([1 if op == "submit" else -1 for op, _ in det.log])
    assert held.max() == min(depth, len(src)) + (depth < len(src))

    ref_src, ref_det = _Scripted(frames, 3, [[p] for p in range(12)]), _Logged()
    in_clip_order = _stream(tmp_path / "in_order", ref_src, ref_det)
    assert [b for op, b in ref_det.log if op == "submit"] == list(range(12))
    assert ref_src.ahead == 0
    assert in_clip_order[0] and len(in_clip_order[0]) < 2 * len(frames)   # some deduped
    _same_faces(landing, in_clip_order)


def _write_clip(path, n_frames=64, fps=10, size=(64, 48), seed=0):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    assert vw.isOpened()
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
        frame[10:40, 5 + i % 20:25 + i % 20] = (200, 170, 150)
        vw.write(frame)
    vw.release()


def _clip(tmp_path):
    video = str(tmp_path / "clip.avi")
    _write_clip(video)
    reader = V.open_reader(video)
    indices, step = V.frame_schedule(reader.length, reader.fps, 0.3, None)
    return video, reader, indices, step


def _drain(src):
    items = []
    while (item := src.take()) is not None:
        items.append(item)
    return items


@pytest.mark.parametrize("workers", [1, 3])
def test_take_hands_over_every_batch_once(tmp_path, workers):
    """On an MJPG clip, ``take`` gives each batch of a parallel source once,
    at its position and with the frames of the one-reader source;
    iteration still yields them in clip order."""
    video, reader, indices, step = _clip(tmp_path)
    single = list(V.PrefetchingFrameSource(reader, indices, step, 2))
    reader.close()
    assert len(single) == 11
    par = V.ParallelFrameSource(video, indices, step, 2, workers=workers)
    items = _drain(par)
    assert par.stop()
    assert sorted(pos for pos, _, _ in items) == list(range(len(single)))
    for pos, bi, frames in items:
        assert bi == single[pos][0]
        np.testing.assert_array_equal(frames, single[pos][1])
    assert par.ahead == _ahead([pos for pos, _, _ in items])
    in_order = list(V.ParallelFrameSource(video, indices, step, 2, workers=workers))
    assert [bi for bi, _ in in_order] == [bi for bi, _ in single]
    for (_, a), (_, b) in zip(in_order, single, strict=True):
        np.testing.assert_array_equal(a, b)


def test_one_reader_lands_in_clip_order(tmp_path):
    video, reader, indices, step = _clip(tmp_path)
    src = V.PrefetchingFrameSource(reader, indices, step, 2)
    items = _drain(src)
    assert src.stop()
    reader.close()
    assert [pos for pos, _, _ in items] == list(range(11)) and src.ahead == 0


def test_take_raises_a_workers_error(tmp_path):
    src = V.ParallelFrameSource(str(tmp_path / "missing.avi"), list(range(3, 60, 3)), 3, 2,
                                workers=3)
    with pytest.raises(RuntimeError, match="could not open video"):
        _drain(src)
    assert src.stop()


def test_stop_releases_workers_waiting_on_full_buffers(tmp_path):
    video, reader, indices, step = _clip(tmp_path)
    reader.close()
    src = V.ParallelFrameSource(video, indices, step, 1, workers=2, depth_per_worker=1)
    assert src.take(in_order=True)[0] == 0
    assert src.stop(timeout=10.0)
    assert not any(t.is_alive() for t in src.threads)


class _Fixed:
    """A detector that finds the same two boxes in every frame."""

    batch_size = None
    device = torch.device("cpu")

    def submit(self, frames):
        return len(frames)

    def collect(self, n):
        return [np.array([[8, 8, 30, 36, 0.9], [20, 6, 44, 40, 0.7]], np.float32)] * n


def test_process_video_gives_the_same_faces_with_parallel_decode(tmp_path, monkeypatch):
    """A clip through ``process_video`` with 3 decode workers, whose batches
    may land out of order, names, hashes and keeps the crops that one
    reader does; ``decode:ahead`` is recorded once per clip."""
    video = str(tmp_path / "clip.avi")
    _write_clip(video)
    runs = []
    for workers in ("1", "3"):
        monkeypatch.setenv("V2F_DECODE_WORKERS", workers)
        layout = specs.OutputLayout(root=str(tmp_path / ("out" + workers)))
        layout.prepare_dirs(True)
        timer, crops = P.StageTimer(), {}
        names, hashes = process_video(video, _Fixed(), specs.FrameSampling(step=0.3),
                                      specs.BoxCriteria(batch_size=2, min_size=10,
                                                        min_border=0),
                                      layout, HASH_THR, timer, crops)
        assert timer.calls["decode:ahead"] == 1
        assert 0 <= timer.items["decode:ahead"] < timer.calls["detect:submit"] == 11
        runs.append((names, hashes, crops))
    assert runs[0][0]
    _same_faces(*runs)
