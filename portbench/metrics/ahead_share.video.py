"""Share of the window's batches that the pipeline's loop submitted while
an earlier batch of their clip was still unsubmitted (the program's
``decode:ahead`` counter, reported once per clip by ``process_video``), in
%."""

def read(run):
    n, b = run.spans.items.get("decode:ahead"), run.counts.get("batches")
    return None if n is None or not b else 100.0 * n / b
