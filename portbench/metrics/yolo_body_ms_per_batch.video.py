"""Host time in YOLO's ``yolo:body`` span per batch, in ms: launching the
preprocess, Darknet-53, the neck and the head, with the waits of the
preprocess's copies of host constants (each a ``host:sync``)."""

def read(run):
    n = run.spans.calls.get("yolo:body")
    return None if not n else 1000.0 * run.spans.total["yolo:body"] / n
