"""Faster R-CNN ResNet-50-FPN (``anime_rcnn_vitb16``): the program's
``FrcnnDetector`` and the plain ``reference/rcnn.py``, whose stand-in for
K4 is ``roi_align_fpn``."""

import torch

from portbench import flops, models

# the sizes at which the harness's CPU tests run it (``tests/tiny.py``)
TINY = {"resize_spec": [96, 160], "proposal_cap": 64, "out_top": 16}


def reference(cfg):
    from portbench.reference.rcnn import AnimeFRCNN

    return AnimeFRCNN(cfg["detector"].get("num_classes", 1))


def program(cfg, device):
    from videotofaces_tpu_torch.models import wrappers as W

    d = cfg["detector"]
    return W.FrcnnDetector(device, resize_spec=tuple(d["resize_spec"]),
                           proposal_cap=d["proposal_cap"], out_top=d["out_top"])


def calibrate(cfg, ref, frames):
    return models.calibrate_heads(cfg, ref, frames)


def kernel_inputs(cfg):
    """K4: each level's (h, w), channels, bytes per element, boxes, valid."""
    from portbench.reference import rcnn as module

    def keep(fmaps, boxes, valid, *rest):
        return ([tuple(f.shape[1:3]) for f in fmaps], fmaps[0].shape[-1],
                fmaps[0].element_size(), boxes.cpu(), valid.cpu())
    return [(module, "roi_align_fpn", keep)]


def detect(cfg, model, frames, batch):
    from portbench.reference import rcnn as R
    from portbench.reference.anchors import get_priors

    d = cfg["detector"]
    dev = next(model.parameters()).device
    h, w = frames[0].shape[:2]
    nh, nw = R.resized_shape(h, w, *d["resize_spec"])
    canvas = R.canvas_shape(nh, nw)
    priors = [torch.from_numpy(p).to(dev) for p in
              get_priors(canvas, R.frcnn_bases(), loc="corner", concat=False)]
    out = []
    for x, n in models.blocks(model, frames, batch):
        with torch.no_grad():
            boxes, scores, _, valid = R.full_forward(
                model, x, (nh, nw), canvas, priors, out_top=d["out_top"],
                proposal_cap=d["proposal_cap"])[:4]
        out += models.valid_rows(boxes, scores, valid, n)
    return out


def work(run, ref, frame):
    """The detector's FLOPs per frame (one forward of ``frame``) times the
    window's frames; K4's work per recorded launch."""
    cfg = run.config
    per_frame = flops.forward_ops(ref, lambda: detect(cfg, ref, [frame[0].cpu().numpy()], 1))
    run.work["model_flops"] = per_frame * run.counts["frames"]
    run.work["roi_align"] = [flops.roi_work(boxes, valid, hw, c, esize)
                             for hw, c, esize, boxes, valid in run.state["kernel_calls"]]
