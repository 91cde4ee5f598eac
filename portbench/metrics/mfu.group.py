"""The encoder's model FLOPs over the window (per face, counted on the
plain reference, times the faces embedded) over the window and the chip's
peak at the configuration's precision, in %."""

from portbench import flops


def read(run):
    f = run.work.get("model_flops")
    if not f or not run.window_s:
        return None
    return 100.0 * f / (run.window_s * flops.peak(run.config["precision"]))
