"""The embedding dedup and the K-means / silhouette sweep per grouping
job, in ms."""

def read(run):
    n = run.spans.calls.get("harness:job")
    if not n:
        return None
    return 1000.0 * (run.spans.total["harness:dedup"] + run.spans.total["harness:sweep"]) / n
