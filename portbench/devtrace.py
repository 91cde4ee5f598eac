"""The device trace of the measured window: ``torch.profiler`` with CUDA
activity over the window, reduced to device intervals (kernels, copies,
sets). Busy time is the union of the intervals inside the window; a
kernel's time is the sum of its intervals; idle gaps are labelled with the
host span open at their midpoint."""

import time
from collections import defaultdict


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    def __init__(self, events=None, window_ns=None):
        """``events``: (name, start_ns, end_ns) device intervals, for a
        trace read elsewhere; by default the context manager profiles."""
        self.events = events
        self.t0, self.t1 = window_ns if window_ns else (None, None)
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self._prof.__exit__(*exc)
        self.events = self._device_events(self._prof)
        self._prof = None
        return False

    @staticmethod
    def _device_events(prof):
        from torch.autograd import DeviceType

        out = []
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
        return out

    def _clipped(self):
        for name, s, e in self.events:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                yield name, s, e

    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        return merge((s, e) for _, s, e in self._clipped())

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_share(self):
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def kernel_s(self, *substrings):
        """Seconds of the device intervals whose name holds any of
        ``substrings``, and their count."""
        total, n = 0, 0
        for name, s, e in self._clipped():
            if any(k in name for k in substrings):
                total += e - s
                n += 1
        return total / 1e9, n

    def kernel_events(self, *substrings):
        """(start_ns, end_ns) of the device intervals whose name holds any
        of ``substrings``, in time order."""
        return sorted((s, e) for name, s, e in self._clipped()
                      if any(k in name for k in substrings))

    def top_ops(self, n=10):
        by = defaultdict(int)
        for name, s, e in self._clipped():
            by[name[:160]] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, spans, n=10):
        """Idle device time summed by the host span open at each gap's
        midpoint (``"none"`` where no span was open)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        labels = spans.labels_at([(s + e) // 2 for s, e in gaps])
        by = defaultdict(int)
        for (s, e), label in zip(gaps, labels):
            by[label or "none"] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self, spans):
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_by_host(spans)}
