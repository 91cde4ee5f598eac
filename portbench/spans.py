"""Host-clock spans: totals and item counts per name, and every interval
(time.time_ns, the profiler's clock) for the idle-gap breakdown. It has
the interface of the program's ``StageTimer`` that ``process_video(timer=)``
uses (``stage(name, items)``), so the pipeline records into it."""

import contextlib
import time
from collections import defaultdict


class SpanRecorder:
    def __init__(self):
        self.total = defaultdict(float)
        self.items = defaultdict(int)
        self.calls = defaultdict(int)
        self.intervals = []
        self.active = True     # record nothing outside the measured window

    @contextlib.contextmanager
    def stage(self, name, items=0):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            if self.active:
                self.total[name] += (t1 - t0) / 1e9
                self.items[name] += items
                self.calls[name] += 1
                self.intervals.append((name, t0, t1))

    def clear(self):
        self.total.clear()
        self.items.clear()
        self.calls.clear()
        self.intervals.clear()

    def labels_at(self, times_ns):
        """For each time in ``times_ns`` (any order), the innermost span open
        then (the latest started), or None."""
        order = sorted(range(len(times_ns)), key=times_ns.__getitem__)
        spans = sorted(self.intervals, key=lambda iv: iv[1])
        out = [None] * len(times_ns)
        active, k = [], 0
        for q in order:
            t = times_ns[q]
            while k < len(spans) and spans[k][1] <= t:
                active.append(spans[k])
                k += 1
            active = [iv for iv in active if iv[2] > t]
            if active:
                out[q] = max(active, key=lambda iv: iv[1])[0]
        return out
