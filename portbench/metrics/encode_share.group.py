"""Share of the grouping jobs' wall time spent in ``encode_faces``
(reading the crops, resizing and the encoder), in %."""

def read(run):
    t, job = run.spans.total.get("harness:encode"), run.spans.total.get("harness:job")
    return None if not t or not job else 100.0 * t / job
