"""Share of the traced window in which no kernel, copy or set ran on
the device (the union of the profiler's device intervals), in %."""

def read(run):
    return None if run.trace is None else run.trace.idle_share()
