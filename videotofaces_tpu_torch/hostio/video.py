"""Video frame reading with the reference's sampling semantics + prefetching.

Contract (reference detection.py:68-119):
- frame indices = range(bgn, end, step) with step = round(fps * video_step),
  bgn/end adjusted by the optional (minutes) fragment;
- OpenCV reading uses seek (CAP_PROP_POS_FRAMES = i-1, then read) when
  step > 50, else sequential grab/retrieve — including the reference's
  one-frame offset quirk in seek mode (kept for output parity);
- optional decord reader (GPU decode upstream); where decord is absent,
  requesting it falls back to OpenCV with a note.

New vs reference: ``PrefetchingFrameSource`` decodes batches in a background
thread (double-buffered) so host decode overlaps device compute instead of
serializing with it (reference loops decode->forward->write sequentially);
``ParallelFrameSource`` splits a clip among several such workers. Both hand
batches over as they land (``take``) or in clip order (iteration), and keep
a ``DecodeTally`` of their workers: the frames grabbed or read, and the time
spent opening, seeking, decoding and cropping.
"""

import threading
import time
from collections import deque

import cv2
import numpy as np

try:  # pragma: no cover - decord is an optional dependency
    import decord  # type: ignore

    HAS_DECORD = True
except ImportError:
    HAS_DECORD = False


def frame_schedule(length, fps, video_step, video_fragment):
    """Sampled frame indices and the step (in frames)."""
    step = round(fps * video_step)
    step = max(step, 1)
    if not video_fragment or video_fragment[0] < 0:
        bgn = step
    else:
        bgn = max(step, round(60 * video_fragment[0] * fps))
    if not video_fragment or video_fragment[1] < 0:
        end = length
    else:
        end = min(length, round(60 * video_fragment[1] * fps + 1))
    return list(range(bgn, end, step)), step


class VideoReader:
    """OpenCV-backed reader with seek-vs-grab strategy. ``decoded`` counts
    the frames it grabbed or read."""

    def __init__(self, path):
        self.cap = cv2.VideoCapture(path)
        self.length = round(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = round(self.cap.get(cv2.CAP_PROP_FPS))
        self._cursor = 0
        self.decoded = 0

    def is_open(self):
        return self.cap.isOpened()

    def seek_to(self, index):
        """Position so the next grab() returns frame ``index`` (used by
        parallel segment decoding; the single-reader path never seeks in
        sequential mode, matching the reference)."""
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, index)
        self._cursor = index

    def read_batch(self, indices, step):
        frames = []
        for i in indices:
            if step > 50:
                # large steps: seeking beats decoding every frame
                self.cap.set(cv2.CAP_PROP_POS_FRAMES, i - 1)
                _, frame = self.cap.read()
                self.decoded += 1
            else:
                # small steps: sequential grab (decode headers only) is faster
                for _ in range(self._cursor, i + 1):
                    self.cap.grab()
                self.decoded += max(0, i + 1 - self._cursor)
                self._cursor = i + 1
                _, frame = self.cap.retrieve()
            frames.append(frame)
        return np.stack(frames)

    def close(self):
        self.cap.release()


class DecordReader:
    """Decord-backed batch reader (GPU decode when decord was built with it)."""

    def __init__(self, path):
        try:
            self.vr = decord.VideoReader(path, decord.gpu())
        except Exception:
            self.vr = decord.VideoReader(path)
        self.length = len(self.vr)
        self.fps = round(self.vr.get_avg_fps())
        self.decoded = 0

    def is_open(self):
        return self.length > 0

    def read_batch(self, indices, step):
        frames = self.vr.get_batch(list(indices)).asnumpy()[..., [2, 1, 0]]  # RGB -> BGR
        self.decoded += len(indices)
        self.vr.seek(0)  # decord#208 seek-state workaround
        return frames

    def close(self):
        pass


def open_reader(path, video_reader="opencv"):
    if video_reader == "decord":
        if HAS_DECORD:
            return DecordReader(path)
        print("NOTE: decord is not available in this environment; using OpenCV decode")
    return VideoReader(path)


class DecodeTally:
    """Totals of a source's decode workers, added under a lock: ``frames``
    grabbed or read, and ``ns`` spent opening, seeking, decoding and
    cropping (time blocked on a full queue left out)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.frames = 0
        self.ns = 0

    def add(self, frames, ns):
        with self._lock:
            self.frames += frames
            self.ns += ns

    def read_batch(self, reader, bi, step, video_area):
        """``reader.read_batch(bi, step)``, cropped to ``video_area``,
        added to the totals (frames by the reader's ``decoded``)."""
        t0, n0 = time.perf_counter_ns(), reader.decoded
        frames = reader.read_batch(bi, step)
        if video_area:
            x1, y1, x2, y2 = video_area
            frames = frames[:, y1:y2, x1:x2, :]
        self.add(reader.decoded - n0, time.perf_counter_ns() - t0)
        return frames


class _SegmentSource:
    """Batches decoded on worker threads: the clip's batch list is cut into
    contiguous segments, one worker each, and every worker holds up to
    ``depth`` decoded batches in a buffer of its own, under one condition.

    ``take`` hands a batch over as soon as it lands, tagged with its
    position in the clip; ``__iter__`` yields the (indices, frames) batches
    in clip order. ``ahead`` counts the batches taken while an earlier one
    was still untaken. Subclasses provide ``_decode(j)``, which decodes
    segment ``j`` through ``_read_segment``."""

    def __init__(self, frame_indices, step, batch_size, video_area, workers, depth):
        self.batches = [frame_indices[i: i + batch_size]
                        for i in range(0, len(frame_indices), batch_size)]
        workers = max(1, min(workers, len(self.batches)))
        seg = -(-len(self.batches) // workers)
        self.segments = [self.batches[j * seg: (j + 1) * seg] for j in range(workers)]
        self._starts = [min(j * seg, len(self.batches)) for j in range(workers)]
        self.step = step
        self.video_area = video_area
        self.tally = DecodeTally()
        self.ahead = 0
        self.errors = [None] * workers
        self._depth = depth
        self._cv = threading.Condition()
        self._held = [deque() for _ in range(workers)]   # landed, not taken
        self._given = [0] * workers                      # taken, per segment
        self._ended = [False] * workers
        self._stop = False          # must exist before any worker starts
        self.threads = [threading.Thread(target=self._work, args=(j,), daemon=True)
                        for j in range(workers)]
        for t in self.threads:
            t.start()

    def _work(self, j):
        try:
            self._decode(j)
        except Exception as e:  # surfaced on the consumer side
            self.errors[j] = e
        finally:
            with self._cv:
                self._ended[j] = True
                self._cv.notify_all()

    def _read_segment(self, j, reader):
        """Decode segment ``j`` with ``reader``, each batch into the worker's
        buffer, waiting while it holds ``depth`` batches."""
        for bi in self.segments[j]:
            if self._stop:
                return
            frames = self.tally.read_batch(reader, bi, self.step, self.video_area)
            with self._cv:
                while len(self._held[j]) >= self._depth and not self._stop:
                    self._cv.wait()
                self._held[j].append((bi, frames))
                self._cv.notify_all()

    def _wait(self):
        self._cv.wait()

    def take(self, in_order=False):
        """The landed batch with the earliest position in the clip, or, with
        ``in_order``, the earliest batch not yet taken; waits until it
        lands. Returns (position, indices, frames), None once every batch
        has been taken, and raises a worker's error where that worker's
        batches are needed and it ended without them."""
        with self._cv:
            while True:
                owed = False
                for j, held in enumerate(self._held):
                    if held:
                        # a worker's buffer holds its segment's batches in
                        # order, so the first one found is the earliest
                        self.ahead += owed
                        bi, frames = held.popleft()
                        pos = self._starts[j] + self._given[j]
                        self._given[j] += 1
                        self._cv.notify_all()
                        return pos, bi, frames
                    if self._given[j] < len(self.segments[j]):
                        if self._ended[j]:
                            raise self.errors[j] or RuntimeError(
                                "decode worker %d stopped before its last batch" % j)
                        owed = True
                        if in_order:
                            break
                if not owed:
                    return None
                self._wait()

    def stop(self, timeout=10.0):
        """Unblock and join every worker. MUST run before a reader a worker
        uses is closed when iteration ends early (consumer exception /
        Ctrl-C): cv2.VideoCapture is not thread-safe against a concurrent
        release, and a worker waiting on its full buffer would otherwise
        leak. Returns True when every worker exited."""
        with self._cv:
            self._stop = True
            for held in self._held:
                held.clear()
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        for t in self.threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self.threads)

    def __iter__(self):
        while (item := self.take(in_order=True)) is not None:
            yield item[1:]

    def __len__(self):
        return len(self.batches)


class PrefetchingFrameSource(_SegmentSource):
    """Iterates (indices, frames, cropped) batches decoded ahead of time by
    one worker on ``reader``, from the clip's start (no seek): the one-reader
    case, whose batches land in clip order.

    ``video_area`` = (x1, y1, x2, y2) optional crop applied after decode
    (detection.py:114-116). ``depth`` is the prefetch buffer's size (2 =
    double buffering).
    """

    def __init__(self, reader, frame_indices, step, batch_size, video_area=None, depth=2):
        self.reader = reader
        super().__init__(frame_indices, step, batch_size, video_area, 1, depth)

    def _decode(self, j):
        self._read_segment(j, self.reader)


def decode_workers_default():
    """How many parallel decoder threads to use: V2F_DECODE_WORKERS, else
    min(4, cpu_count - 1). On a 1-core host this is 1 (the plain prefetching
    single reader, bit-identical to the reference's decode order)."""
    import os

    env = os.environ.get("V2F_DECODE_WORKERS")
    if env:
        return max(1, int(env))
    return max(1, min(4, (os.cpu_count() or 1) - 1))


class ParallelFrameSource(_SegmentSource):
    """Parallel decode: the batch list is split into ``workers`` contiguous
    segments, each decoded by its own reader thread (own cv2/decord handle,
    seek to segment start, then the same seek-vs-grab strategy). ``take``
    hands batches over as they land; iteration drains the segments in
    order, so it yields the same (indices, frames) batches as
    PrefetchingFrameSource.

    This is the "keep host decode from starving the device" lever (SURVEY §7):
    decode throughput scales with cores while the device pipeline is
    unchanged.
    """

    def __init__(self, path, frame_indices, step, batch_size, video_area=None,
                 reader_kind="opencv", workers=None, depth_per_worker=4):
        # depth 4: enough to hide segment handoff; 16 would buffer ~800 MB of
        # raw 1080p frames PER WORKER at batch 8
        self.path = path
        self.reader_kind = reader_kind
        super().__init__(frame_indices, step, batch_size, video_area,
                         workers or decode_workers_default(), depth_per_worker)

    def _decode(self, j):
        seg_batches = self.segments[j]
        if not seg_batches:
            return
        t0 = time.perf_counter_ns()
        reader = open_reader(self.path, self.reader_kind)
        try:  # close on error/stop paths too
            if not reader.is_open():
                raise RuntimeError("could not open video: %s" % self.path)
            if hasattr(reader, "seek_to") and self.step <= 50:
                # sequential-grab strategy: start decoding at the segment head
                # instead of replaying the whole prefix
                reader.seek_to(seg_batches[0][0])
            self.tally.add(0, time.perf_counter_ns() - t0)
            self._read_segment(j, reader)
        finally:
            reader.close()
