"""Time at a clip's edges per clip run (the program's ``video:open``:
the reader, the frame schedule and the decode workers' start;
``video:close``: joining the workers and closing the reader;
``writer:join``: the last JPEG writes), in ms."""

NAMES = ("video:open", "video:close", "writer:join")


def read(run):
    t, n = [run.spans.total.get(k) for k in NAMES], run.counts.get("clips")
    return None if None in t or not n else 1000.0 * sum(t) / n
