"""Candidates entering YOLO's NMS per sampled frame (the program's
``yolo:candidates`` counter, the valid slots of each batch's selection,
recorded once the batch has landed)."""

def read(run):
    n, f = run.spans.items.get("yolo:candidates"), run.counts.get("frames")
    return None if n is None or not f else n / f
