"""The MTCNN cascade (``live_mtcnn_facenet``): the program's
``MtcnnDetector`` and the plain ``reference/mtcnn.py``, whose stand-in for
K3 is ``pool_crops`` (K1/K2's work follows from the frame size alone)."""

import numpy as np
import torch

from portbench import flops, models

# the size at which the harness's CPU tests run it (``tests/tiny.py``)
TINY = {"min_face_size": 24}

# the stage counts kept per image: stage 1's most on one scale, the
# candidates entering the cross-scale NMS, RNet's and ONet's survivors
STAGES = ("stage1_scale_max", "cross_in", "stage2", "stage3")


def reference(cfg):
    from portbench.reference.mtcnn import MTCNN

    return MTCNN()


def program(cfg, device):
    from videotofaces_tpu_torch.models import wrappers as W

    return W.MtcnnDetector(device, min_face_size=cfg["detector"]["min_face_size"])


def calibrate(cfg, ref, frames):
    return models.calibrate_heads(cfg, ref, frames)


def kernel_inputs(cfg):
    """K3: (b, h, w), the slot table, the crop size."""
    from portbench.reference import mtcnn as module

    def keep(frames, slots, size):
        return tuple(frames.shape[:3]), slots.cpu().numpy(), size
    return [(module, "pool_crops", keep)]


def detect(cfg, model, frames, batch):
    from portbench.reference import mtcnn as M

    out = []
    for x, n in models.blocks(model, frames, batch):
        with torch.no_grad():
            boxes, scores, _, valid, _ = M.full_forward(
                model, x.contiguous(), minsize=cfg["detector"]["min_face_size"])
        out += models.valid_rows(boxes, scores, valid, n)
    return out


def stage_counts(handle):
    """{stage: per-image counts} of a collected batch (padding rows
    included), None for a batch split over shards."""
    counts = handle[0][0][4] if isinstance(handle[0][0], tuple) else None
    if not isinstance(counts, dict):
        return None
    return {k: counts[k].numpy() for k in STAGES}


def work(run, ref, frame):
    """PNet over every pyramid level of each frame, RNet and ONet at the
    window's stage counts, capped by their buffers (the candidates entering
    RNet are counted before the cross-scale NMS, an upper bound); K1 + K2
    for every batch of the window; K3's work per recorded launch."""
    from portbench.reference import mtcnn as M

    dev = frame.device
    h, w = frame.shape[1:3]
    frames = run.counts["frames"]
    scales, sizes = M.scale_pyramid(h, w, run.config["detector"]["min_face_size"])
    pnet = sum(flops.forward_ops(ref.pnet, lambda s=s: ref.pnet(
        torch.zeros(1, 3, s[0], s[1], device=dev))) for s in sizes)
    rnet = flops.forward_ops(ref.rnet, lambda: ref.rnet(torch.zeros(1, 3, 24, 24, device=dev)))
    onet = flops.forward_ops(ref.onet, lambda: ref.onet(torch.zeros(1, 3, 48, 48, device=dev)))
    caps = M.Caps()
    n2 = n3 = 0
    for c in run.state["stage_counts"]:
        n2 += int(np.minimum(c["cross_in"], caps.stage2).sum())
        n3 += int(np.minimum(c["stage2"], caps.stage3).sum())
    run.work["model_flops"] = pnet * frames + rnet * n2 + onet * n3
    b = run.traffic["batch_size"]
    run.work["pnet"] = [flops.pnet_work(s, b, h, w) for s in sizes] * run.counts["batches"]
    run.work["pool_crops"] = [flops.crops_work(slots, size, *bhw)
                              for bhw, slots, size in run.state["kernel_calls"]]
