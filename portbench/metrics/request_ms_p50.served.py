"""The median of the same request times as ``request_ms_p95`` (from each
request's scheduled send time to its response), in ms."""


def read(run):
    return run.work.get("request_ms_p50")
