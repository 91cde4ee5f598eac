"""The decode workers' own time per sampled frame (the program's
``decode:worker_us`` counter: open, seek, grab, retrieve and crop, summed
over the workers, time blocked on a full queue left out), in ms."""

def read(run):
    us, f = run.spans.items.get("decode:worker_us"), run.counts.get("frames")
    return None if us is None or not f else us / 1000.0 / f
