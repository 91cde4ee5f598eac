"""Frames the decode workers grabbed or read per sampled frame (the
program's ``decode:frames`` counter, reported once per clip by
``process_video``)."""

def read(run):
    n, f = run.spans.items.get("decode:frames"), run.counts.get("frames")
    return None if n is None or not f else n / f
