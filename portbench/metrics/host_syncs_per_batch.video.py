"""Host round trips per detector batch: the program's ``host:sync`` spans
(each NMS fixpoint convergence check, the bucket check, each stream-syncing
copy of a host constant inside ``submit``) over the batches collected in
the window."""

def read(run):
    n, b = run.spans.calls.get("host:sync"), run.counts.get("batches")
    return None if n is None or not b else n / b
