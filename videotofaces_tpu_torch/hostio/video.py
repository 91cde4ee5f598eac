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
thread (double-buffered queue) so host decode overlaps device compute instead
of serializing with it (reference loops decode->forward->write sequentially).
Both sources keep a ``DecodeTally`` of their workers: the frames grabbed or
read, and the time spent opening, seeking, decoding and cropping.
"""

import queue
import threading
import time

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


class PrefetchingFrameSource:
    """Iterates (indices, frames, cropped) batches decoded ahead of time.

    ``video_area`` = (x1, y1, x2, y2) optional crop applied after decode
    (detection.py:114-116). ``depth`` is the prefetch queue size (2 =
    double buffering).
    """

    _END = object()

    def __init__(self, reader, frame_indices, step, batch_size, video_area=None, depth=2):
        self.reader = reader
        self.batches = [frame_indices[i: i + batch_size]
                        for i in range(0, len(frame_indices), batch_size)]
        self.step = step
        self.video_area = video_area
        self.queue = queue.Queue(maxsize=depth)
        self.tally = DecodeTally()
        self.error = None
        self._stop = False
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for bi in self.batches:
                if self._stop:
                    break
                frames = self.tally.read_batch(self.reader, bi, self.step, self.video_area)
                self.queue.put((bi, frames))
        except Exception as e:  # surfaced on the consumer side
            self.error = e
        finally:
            self.queue.put(self._END)

    def stop(self, timeout=10.0):
        """Unblock and join the decode thread. MUST run before the reader is
        closed when iteration ends early (consumer exception / Ctrl-C):
        cv2.VideoCapture is not thread-safe against a concurrent release,
        and a worker blocked on the bounded queue would otherwise leak.
        Returns True when the thread exited (reader safe to close)."""
        self._stop = True
        deadline = time.monotonic() + timeout
        while self.thread.is_alive() and time.monotonic() < deadline:
            try:  # drain so a blocked put() returns and the flag is seen
                self.queue.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
        return not self.thread.is_alive()

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is self._END:
                if self.error:
                    raise self.error
                return
            yield item

    def __len__(self):
        return len(self.batches)


def decode_workers_default():
    """How many parallel decoder threads to use: V2F_DECODE_WORKERS, else
    min(4, cpu_count - 1). On a 1-core host this is 1 (the plain prefetching
    single reader, bit-identical to the reference's decode order)."""
    import os

    env = os.environ.get("V2F_DECODE_WORKERS")
    if env:
        return max(1, int(env))
    return max(1, min(4, (os.cpu_count() or 1) - 1))


class ParallelFrameSource:
    """Order-preserving parallel decode: the batch list is split into
    ``workers`` contiguous segments, each decoded by its own reader thread
    (own cv2/decord handle, seek to segment start, then the same seek-vs-grab
    strategy); the consumer drains the segments in order, so downstream
    semantics (frame order, prev-5 dedup window, filenames) are identical to
    the single-reader path.

    This is the "keep host decode from starving the device" lever (SURVEY §7):
    decode throughput scales with cores while the device pipeline is
    unchanged. Yields the same (indices, frames) batches as
    PrefetchingFrameSource.
    """

    _END = object()

    def __init__(self, path, frame_indices, step, batch_size, video_area=None,
                 reader_kind="opencv", workers=None, depth_per_worker=4):
        # depth 4: enough to hide segment handoff; 16 would buffer ~800 MB of
        # raw 1080p frames PER WORKER at batch 8
        workers = workers or decode_workers_default()
        self.batches = [frame_indices[i: i + batch_size]
                        for i in range(0, len(frame_indices), batch_size)]
        workers = max(1, min(workers, len(self.batches)))
        seg = -(-len(self.batches) // workers)
        self.segments = [self.batches[j * seg: (j + 1) * seg] for j in range(workers)]
        self.step = step
        self.video_area = video_area
        self.queues = [queue.Queue(maxsize=depth_per_worker) for _ in self.segments]
        self.tally = DecodeTally()
        self.errors = [None] * len(self.segments)
        self._stop = False          # must exist before any worker starts
        self.threads = []
        for j, seg_batches in enumerate(self.segments):
            t = threading.Thread(target=self._work, daemon=True,
                                 args=(j, path, reader_kind, seg_batches))
            t.start()
            self.threads.append(t)

    def _work(self, j, path, reader_kind, seg_batches):
        q = self.queues[j]
        reader = None
        try:
            if not seg_batches:
                return
            t0 = time.perf_counter_ns()
            reader = open_reader(path, reader_kind)
            if not reader.is_open():
                raise RuntimeError("could not open video: %s" % path)
            if hasattr(reader, "seek_to") and self.step <= 50:
                # sequential-grab strategy: start decoding at the segment head
                # instead of replaying the whole prefix
                reader.seek_to(seg_batches[0][0])
            self.tally.add(0, time.perf_counter_ns() - t0)
            for bi in seg_batches:
                if self._stop:
                    break
                q.put((bi, self.tally.read_batch(reader, bi, self.step, self.video_area)))
        except Exception as e:
            self.errors[j] = e
        finally:
            if reader is not None:  # close on error/stop paths too
                reader.close()
            q.put(self._END)

    def stop(self, timeout=10.0):
        """Unblock and join every worker (each owns its reader, closed in its
        own finally); call when iteration ends early."""
        self._stop = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [t for t in self.threads if t.is_alive()]
            if not alive:
                break
            for q in self.queues:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
            alive[0].join(timeout=0.05)
        return not any(t.is_alive() for t in self.threads)

    def __iter__(self):
        for j, q in enumerate(self.queues):
            while True:
                item = q.get()
                if item is self._END:
                    if self.errors[j]:
                        raise self.errors[j]
                    break
                yield item

    def __len__(self):
        return len(self.batches)
