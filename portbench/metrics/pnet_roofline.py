"""K1 + K2 (``pnet_level``: ``pool_level_kernel``, ``pnet_level_kernel``,
``pnet_tc_kernel``): the least time of every level of every batch of the
window (frozen ``pnet_work``) over the kernels' device time, in %."""

from portbench import flops

KERNELS = ("pool_level_kernel", "pnet_level_kernel", "pnet_tc_kernel")


def read(run):
    work = run.work.get("pnet")
    if not work or run.trace is None:
        return None
    t, n = run.trace.kernel_s(*KERNELS)
    if not n:
        return None
    return 100.0 * sum(flops.bound_s(b, o, "float32")[0] for b, o in work) / t
