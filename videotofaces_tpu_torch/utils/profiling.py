"""Per-stage timing and an optional device trace.

- ``StageTimer`` accumulates wall-time per pipeline stage (decode, detect,
  filter, write, ...) with throughput summaries;
- ``trace(dir)`` wraps ``torch.profiler`` (CPU + CUDA activity) around a
  block and writes a Chrome trace there; a no-op unless a directory is given
  or V2F_PROFILE_DIR is set:
  ``V2F_PROFILE_DIR=/tmp/trace python -m videotofaces_tpu_torch ...``;
- ``sync(out)`` waits for the device that holds ``out``, ``annotate(name)``
  names a span inside a trace.
"""

import contextlib
import os
import os.path as osp
import time
from collections import defaultdict


class StageTimer:
    """Accumulates per-stage wall time + item counts."""

    def __init__(self):
        self.total = defaultdict(float)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name, items=0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.items[name] += items

    def summary(self):
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            t = self.total[name]
            n = self.items[name]
            rate = f", {n / t:.1f} items/s" if (n and t > 0) else ""
            lines.append(f"  {name}: {t:.3f}s ({n} items{rate})")
        return "\n".join(lines)

    def report(self):
        if self.total:
            print("Stage timings:")
            print(self.summary())


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler trace around a block; no-op if log_dir is falsy."""
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
        yield
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
