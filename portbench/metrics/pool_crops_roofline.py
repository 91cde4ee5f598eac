"""K3 (``pool_crops_kernel``): the least time of the window's first launches (frozen
``crops_work`` over their slot tables, as the reference's check pass of the
same batches saw them) over those launches' device time, in %."""

from portbench import flops


def read(run):
    work = run.work.get("pool_crops")
    if not work or run.trace is None:
        return None
    events = run.trace.kernel_events("pool_crops_kernel")[:len(work)]
    if len(events) < len(work):
        return None
    t = sum(e - s for s, e in events) / 1e9
    return 100.0 * sum(flops.bound_s(b, o, "float32")[0] for b, o in work) / t
