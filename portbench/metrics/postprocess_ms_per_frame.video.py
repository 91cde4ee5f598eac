"""Host post-processing per sampled frame (``host:postprocess``: box
filter, crops, the window hash dedup, queueing the JPEG writes), in ms."""

def read(run):
    t, n = run.spans.total.get("host:postprocess"), run.counts.get("frames")
    return None if t is None or not n else 1000.0 * t / n
