"""Host time in the detector per batch (``detect:submit`` +
``detect:collect``: copies, launches, the cascade's host syncs and the
wait for results), in ms."""

def read(run):
    n = run.spans.calls.get("detect:collect")
    if not n:
        return None
    return 1000.0 * (run.spans.total["detect:submit"] + run.spans.total["detect:collect"]) / n
