"""Box math on fixed-shape tensors (counterpart of videotofaces_tpu/ops/boxes.py)."""

import torch


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
