"""The detector's model FLOPs over the window (convolutions and dense
layers, counted on the plain reference; MTCNN's RNet / ONet at the stage
counts the cascade returned) over the window and the chip's peak at the
configuration's precision, in %."""

from portbench import flops


def read(run):
    f = run.work.get("model_flops")
    if not f or not run.window_s:
        return None
    return 100.0 * f / (run.window_s * flops.peak(run.config["precision"]))
