"""Frozen copy of the port's ops/boxes.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import math

import torch


def decode_boxes(pred, priors, mults=(1.0, 1.0), clamp=False, mode="rcnn", strides=None):
    """Regression outputs -> (x1, y1, x2, y2) boxes around (cx, cy, w, h)
    priors. pred / priors: [..., 4]. Reference behaviour:
    operations/bbox.py:6-34.

    ``mode="rcnn"``: R-CNN Eq. 1-4 with variance multipliers ``mults``,
    xy = prior_wh * mult_xy * txy + prior_xy. ``mode="yolo"``: xy =
    strides * (sigmoid(txy) - 0.5) + prior_xy, with ``strides``
    broadcastable against pred[..., :1]. Both: wh = prior_wh * exp(mult_wh
    * twh), the exponent clamped at log(1000 / 16) with ``clamp``
    (torchvision's convention)."""
    if mode not in ("rcnn", "yolo"):
        raise ValueError(f"unknown decode mode {mode!r}")
    mult_xy, mult_wh = mults
    if mode == "rcnn":
        xys = priors[..., 2:] * mult_xy * pred[..., :2] + priors[..., :2]
    else:
        xys = strides * (torch.sigmoid(pred[..., :2]) - 0.5) + priors[..., :2]
    twh = mult_wh * pred[..., 2:]
    if clamp:
        twh = torch.clamp(twh, max=math.log(1000.0 / 16))
    whs = priors[..., 2:] * torch.exp(twh)
    return torch.cat([xys - whs * 0.5, xys + whs * 0.5], dim=-1)


def convert_to_cwh(boxes):
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Reference: operations/bbox.py:37-42."""
    wh = boxes[..., 2:] - boxes[..., :2]
    return torch.cat([boxes[..., :2] + wh * 0.5, wh], dim=-1)


def clamp_to_canvas(boxes, sizes_hw):
    """Clamp boxes [..., 4] into canvases ``sizes_hw`` [..., 2] (h, w),
    broadcastable against the boxes' leading dims (operations/bbox.py:45-49)."""
    wh = sizes_hw.flip(-1)
    mx = torch.cat([wh, wh], dim=-1)
    return torch.minimum(torch.clamp(boxes, min=0.0), mx)


def small_boxes_mask(boxes, min_size=0.0):
    """True for boxes whose width AND height exceed ``min_size`` (the mask
    form of the reference's ``remove_small``, operations/bbox.py:52-60)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws > min_size) & (hs > min_size)


def box_iou_matrix(boxes_a, boxes_b, plus_one=False, mode="iou"):
    """Pairwise IoU (or intersection-over-minimum, ``mode="iom"``) matrix:
    [..., Na, Nb].

    ``plus_one`` adds 1px to widths/heights (legacy MTCNN convention,
    reference detectors/mtcnn.py:286-297). Same float32 operation order as the
    JAX op, so masks thresholded on it agree exactly.
    """
    off = 1.0 if plus_one else 0.0
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(ix2 - ix1 + off, min=0.0)
    ih = torch.clamp(iy2 - iy1 + off, min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    if mode == "iom":
        denom = torch.minimum(area_a, area_b)
    else:
        denom = area_a + area_b - inter
    return inter / torch.clamp(denom, min=1e-12)
