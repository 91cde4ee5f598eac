"""Per-stage timing, spans inside the layers, and an optional device trace.

- ``StageTimer`` accumulates wall time per stage (decode, detect, filter,
  write, ...) on ``time.time_ns``, the clock of ``torch.profiler``'s device
  events, and keeps every interval with the index of its parent span, so
  ``summary()`` gives nested stages their self time;
- ``recording(timer)`` binds a recorder (any object with
  ``stage(name, items)``, a ``StageTimer`` or a benchmark's own) to the
  calling thread; ``span(name)`` and ``count(name, n)`` record into it from
  any layer below (the detectors, the NMS, the decode sources) and cost one
  thread-local lookup where none is bound, as in every other thread;
- ``trace(dir)`` wraps ``torch.profiler`` (CPU + CUDA activity) around a
  block and writes a Chrome trace there, where ``span`` also names its
  intervals on the kernels' timeline; a no-op unless a directory is given
  or V2F_PROFILE_DIR is set:
  ``V2F_PROFILE_DIR=/tmp/trace python -m videotofaces_tpu_torch ...``;
- ``sync(out)`` waits for the device that holds ``out``, ``annotate(name)``
  names a span inside a trace.
"""

import contextlib
import os
import os.path as osp
import threading
import time
from array import array
from collections import defaultdict


class _Bound(threading.local):
    """The calling thread's recorder (a class default, so that a thread
    with none finds None without a failed lookup)."""

    timer = None


_bound = _Bound()
_NOOP = contextlib.nullcontext()
_traces = 0                    # trace() blocks open, in any thread


class StageTimer:
    """Accumulates per-stage wall time, item counts and calls, and keeps
    every interval (name, start_ns, end_ns, index of the parent interval or
    -1). A stage opened inside another is its child; one thread at a time
    records into a timer (``recording`` binds it to one)."""

    def __init__(self):
        self.total = defaultdict(float)
        self.self_total = defaultdict(float)   # total less the children's time
        self.items = defaultdict(int)
        self.calls = defaultdict(int)
        # start, end, parent per interval, packed: a long job records ~100
        # spans per batch, 32 bytes each here against ~150 as tuples
        self._names = []
        self._bounds = array("q")
        self._open = []     # [index, children's ns] per open stage

    @contextlib.contextmanager
    def stage(self, name, items=0):
        parent = self._open[-1] if self._open else None
        k = len(self._names)
        self._names.append(name)
        t0 = time.time_ns()
        self._bounds.extend((t0, t0, parent[0] if parent else -1))
        frame = [k, 0]
        self._open.append(frame)
        try:
            yield
        finally:
            t1 = time.time_ns()
            self._open.pop()
            self._bounds[3 * k + 1] = t1
            dt = t1 - t0
            self.total[name] += dt / 1e9
            self.self_total[name] += (dt - frame[1]) / 1e9
            self.items[name] += items
            self.calls[name] += 1
            if parent:
                parent[1] += dt

    @property
    def intervals(self):
        """[(name, start_ns, end_ns, parent index or -1)] in start order."""
        b = self._bounds
        return [(n, b[3 * k], b[3 * k + 1], b[3 * k + 2]) for k, n in enumerate(self._names)]

    def summary(self):
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            t = self.total[name]
            n = self.items[name]
            own = self.self_total[name]
            nested = f", self {own:.3f}s" if t - own > 1e-9 else ""
            rate = f", {n / t:.1f} items/s" if (n and t > 0) else ""
            lines.append(f"  {name}: {t:.3f}s{nested} ({self.calls[name]} calls, "
                         f"{n} items{rate})")
        return "\n".join(lines)

    def report(self):
        if self.total:
            print("Stage timings:")
            print(self.summary())


@contextlib.contextmanager
def recording(timer):
    """Bind ``timer`` as the calling thread's recorder for the block (the
    binding it replaces comes back after)."""
    prev = _bound.timer
    _bound.timer = timer
    try:
        yield timer
    finally:
        _bound.timer = prev


def span(name, items=0):
    """``timer.stage(name, items)`` of the calling thread's recorder; while
    ``trace()`` runs, also a ``record_function`` of the same name. With
    neither, one shared no-op context."""
    timer = _bound.timer
    if _traces:
        return _traced(timer, name, items)
    return _NOOP if timer is None else timer.stage(name, items)


def count(name, n):
    """Record a counter: a span of no length whose items carry ``n``."""
    timer = _bound.timer
    if timer is not None:
        with timer.stage(name, n):
            pass


def sync_span(device):
    """A ``host:sync`` span (items 1) around a call that blocks the host on
    ``device``'s stream, such as a copy of a host constant to the card;
    nothing for a CPU device, where the call waits on no device."""
    return span("host:sync", 1) if device.type == "cuda" else _NOOP


@contextlib.contextmanager
def _traced(timer, name, items):
    from torch.profiler import record_function

    with record_function(name), (_NOOP if timer is None else timer.stage(name, items)):
        yield


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler trace around a block; no-op if log_dir is falsy."""
    global _traces
    log_dir = log_dir or os.environ.get("V2F_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        _traces += 1
        try:
            yield
        finally:
            _traces -= 1
    path = osp.join(log_dir, "trace_%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    print(f"Wrote device trace to {path} (open with chrome://tracing or Perfetto)")


def _first_tensor(out):
    import torch

    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) \
        else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def sync(out):
    """Device-completion barrier for a timing loop: wait until every launch
    queued on the device of ``out``'s first tensor (a tensor or a nested
    list / tuple / dict) has finished. A CPU tensor, or no tensor, needs no
    wait."""
    import torch

    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def annotate(name):
    """Named span inside a ``torch.profiler`` trace (cheap without one)."""
    from torch.profiler import record_function

    return record_function(name)
