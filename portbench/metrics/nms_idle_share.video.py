"""Share of the traced window in which the device sat idle while the
program solved an NMS fixpoint (a gap whose midpoint falls inside an
``nms:fixpoint`` span, its ``host:sync`` convergence checks included), in
%. The gaps are labelled by ``idle_by_host`` over the fixpoint spans
alone, so a ``host:sync`` elsewhere (a constant's copy) does not count."""

from portbench.spans import SpanRecorder


def read(run):
    if run.trace is None:
        return None
    fixpoints = SpanRecorder()
    fixpoints.intervals = [iv for iv in run.spans.intervals if iv[0] == "nms:fixpoint"]
    if not fixpoints.intervals:
        return None
    idle = dict(run.trace.idle_by_host(fixpoints, n=2))
    return 100.0 * idle.get("nms:fixpoint", 0.0) / run.trace.window_s()
