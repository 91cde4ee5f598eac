"""Frozen copy of the port's models/rcnn.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .anchors import make_anchors
from .boxes import clamp_to_canvas, convert_to_cwh, decode_boxes, small_boxes_mask
from .nms import nms_keep_mask, take_rows, topk_by_score
from .resize import bilinear_resize_matmul
from .roi_align import roi_align_fpn
from .layers import ConvUnit
from .resnet import ResNet

STRIDES = (4, 8, 16, 32, 64)
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
NMS_T = 256     # "default" precision: exact RPN NMS over each level's top 256


def _upsample_nearest(x, out_hw):
    """torch F.interpolate(mode='nearest', size=...) of NCHW maps, with the
    JAX package's numpy indices: src = floor(dst * in / out)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    iy = torch.from_numpy((np.arange(oh) * (h / oh)).astype(np.int64)).to(x.device)
    ix = torch.from_numpy((np.arange(ow) * (w / ow)).astype(np.int64)).to(x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


class FPN(nn.Module):
    """1x1 laterals + top-down nearest upsampling + 3x3 smooths + an extra
    stride-2 subsample level (rcnn.py:16-31). Returns [P2, ..., P6]."""

    def __init__(self, cins=(256, 512, 1024, 2048), cout=256):
        super().__init__()
        self.n = len(cins)
        for i, cin in enumerate(cins):
            self.add_module(f"lateral{i}", ConvUnit(cin, cout, 1, 1, 0, None, None))
        for i in range(self.n):
            self.add_module(f"smooth{i}", ConvUnit(cout, cout, 3, 1, 1, None, None))

    def forward(self, feats):
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 2, -1, -1):
            lat[i] = lat[i] + _upsample_nearest(lat[i + 1], lat[i].shape[-2:])
        outs = [getattr(self, f"smooth{i}")(lat[i]) for i in range(self.n)]
        outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs


class RPNHead(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness and regression heads per
    level. Returns per-level regs [B, H*W*A, 4] and logits [B, H*W*A]."""

    def __init__(self, cin=256, num_anchors=3):
        super().__init__()
        self.conv = ConvUnit(cin, 256, 3, 1, 1, "relu", None)
        self.log = nn.Conv2d(256, num_anchors, 1)
        self.reg = nn.Conv2d(256, num_anchors * 4, 1)

    def forward(self, feats):
        regs, logs = [], []
        for f in feats:
            y = self.conv(f)
            b = y.shape[0]
            regs.append(self.reg(y).permute(0, 2, 3, 1).reshape(b, -1, 4))
            logs.append(self.log(y).permute(0, 2, 3, 1).reshape(b, -1))
        return regs, logs


class RoIHead(nn.Module):
    """Two 1024-wide ReLU layers on the flattened 7x7xC pooled maps, then the
    class logits (num_classes + background, background last) and the box
    regressions."""

    def __init__(self, num_classes=1, cin=256 * 7 * 7, hidden=1024):
        super().__init__()
        self.fc0 = nn.Linear(cin, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, 1 + num_classes)
        self.reg = nn.Linear(hidden, num_classes * 4)

    def forward(self, roi_maps):          # [N, 7, 7, C]
        x = roi_maps.reshape(roi_maps.shape[0], -1)
        x = self.fc1(self.fc0(x).relu()).relu()
        return self.reg(x), self.cls(x)


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN: returns (pyramid [P2..P6], regs, logs)."""

    def __init__(self, block_counts=(3, 4, 6, 3)):
        super().__init__()
        self.backbone = ResNet(block_counts)
        self.fpn = FPN()
        self.rpn = RPNHead()

    def forward(self, x):
        pyramid = self.fpn(self.backbone(x))
        regs, logs = self.rpn(pyramid)
        return pyramid, regs, logs


class AnimeFRCNN(nn.Module):
    """The detector's two parameter sets: ``body`` (FasterRCNN) and ``head``
    (RoIHead), as the JAX package's ``{"body", "head"}`` tree."""

    def __init__(self, num_classes=1):
        super().__init__()
        self.num_classes = num_classes
        self.body = FasterRCNN()
        self.head = RoIHead(num_classes)

def frcnn_bases():
    anchors = make_anchors([32, 64, 128, 256, 512], [1], [2, 1, 0.5])
    return list(zip(STRIDES, anchors))


def rpn_proposals(regs, logs, priors_per_level, canvas_used_hw, lvtop=1000,
                  out_top=1000, iou_thr=0.7):
    """Fixed-capacity proposal generation (rcnn.py:49-82 semantics).

    regs / logs: per-level [B, D_l, 4] / [B, D_l] float32; priors_per_level:
    per-level [D_l, 4] (cx, cy, w, h) tensors; canvas_used_hw: [B, 2] the
    used canvas sizes. Returns (proposals [B, out_top, 4], valid [B,
    out_top], select_overflow [B] int32).

    Per level, the top ``min(lvtop, D_l)`` logits by a stable descending sort
    (lower index first on ties, as ``lax.top_k``), decoded and padded to
    ``lvtop``; NMS runs per (image, level). In precision ``"default"`` with
    ``lvtop > 256`` it is two-pass, as in the JAX package: exact over each
    level's first 256 slots (they are score-sorted), the tail dropped, and
    every dropped valid candidate that scores above the final cut-off (all
    of them when the output is not full) counted into ``select_overflow``."""
    b = regs[0].shape[0]
    nl = len(regs)
    dev = regs[0].device
    fast = False   # the "highest" path: exact NMS
    boxes_l, obj_l, valid_l = [], [], []
    for reg, log, pri in zip(regs, logs, priors_per_level):
        k = min(lvtop, log.shape[1])
        vals, idx = torch.sort(log, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        bx = decode_boxes(take_rows(reg, idx), pri[idx])
        pad = lvtop - k
        boxes_l.append(torch.nn.functional.pad(bx, (0, 0, 0, pad)))
        obj_l.append(torch.nn.functional.pad(torch.sigmoid(vals), (0, pad)))
        valid_l.append(torch.nn.functional.pad(torch.ones_like(vals, dtype=torch.bool), (0, pad)))
    boxes = torch.stack(boxes_l, dim=1)                            # [B, L, T, 4]
    obj = torch.stack(obj_l, dim=1)                                # [B, L, T]
    valid = torch.stack(valid_l, dim=1)

    boxes = clamp_to_canvas(boxes, canvas_used_hw[:, None, None, :])
    valid = valid & small_boxes_mask(boxes, 0.0)
    two_pass = fast and lvtop > NMS_T
    if two_pass:
        keep = nms_keep_mask(boxes[:, :, :NMS_T], None, valid[:, :, :NMS_T], iou_thr,
                             presorted=True)
        keep = torch.nn.functional.pad(keep, (0, lvtop - NMS_T))
    else:
        keep = nms_keep_mask(boxes, obj, valid, iou_thr)
    obj_flat = obj.reshape(b, nl * lvtop)
    idx, out_valid = topk_by_score(obj_flat, keep.reshape(b, nl * lvtop), out_top)
    out_boxes = take_rows(boxes.reshape(b, nl * lvtop, 4), idx)
    overflow = torch.zeros((b,), dtype=torch.int32, device=dev)
    if two_pass:
        sel = torch.gather(obj_flat, 1, idx)
        inf = torch.full_like(sel, float("inf"))
        cutoff = torch.where(out_valid.all(dim=1),
                             torch.where(out_valid, sel, inf).min(dim=1).values,
                             torch.full_like(sel[:, 0], -1.0))
        risk = (obj[:, :, NMS_T:] > cutoff[:, None, None]) & valid[:, :, NMS_T:]
        overflow = overflow + risk.sum(dim=(1, 2)).to(torch.int32)
    return out_boxes, out_valid, overflow


def roi_detections(apply_head, pyramid, proposals, pvalid, canvas_used_hw,
                   num_classes=1, score_thr=0.05, iou_thr=0.5, out_top=100):
    """RoIAlign + head + fixed-capacity final decode / NMS (rcnn.py:103-124).
    ``pyramid``: NCHW [P2..P6]; the RoIAlign pools P2..P5. Returns (boxes
    [B, out_top, 4], scores, classes, valid, roi_dropped [B], roi_truncated
    [B])."""
    b, r = proposals.shape[:2]
    fmaps = [p.permute(0, 2, 3, 1).contiguous() for p in pyramid[:4]]   # NHWC
    roi_maps, roi_dropped, roi_kept, roi_truncated = roi_align_fpn(
        fmaps, proposals, pvalid, STRIDES[:4])
    pvalid = pvalid & roi_kept
    reg, cls = apply_head(roi_maps.reshape((b * r,) + roi_maps.shape[2:]))
    nc = num_classes
    reg = reg.reshape(b, r, nc, 4)
    scr = torch.softmax(cls.reshape(b, r, nc + 1), dim=-1)[..., :-1]    # drop background

    priors = convert_to_cwh(proposals)[:, :, None, :]                  # [B, R, 1, 4]
    boxes = decode_boxes(reg, priors, mults=(0.1, 0.2))                # [B, R, nc, 4]
    boxes = clamp_to_canvas(boxes, canvas_used_hw[:, None, None, :])
    valid = (scr > score_thr) & pvalid[:, :, None] & small_boxes_mask(boxes, 0.0)

    flat_boxes = boxes.reshape(b, r * nc, 4)
    flat_scores = scr.reshape(b, r * nc)
    class_ids = torch.arange(nc, dtype=torch.int32, device=proposals.device).repeat(r)
    keep = nms_keep_mask(flat_boxes, flat_scores, valid.reshape(b, r * nc), iou_thr,
                         class_ids)
    idx, out_valid = topk_by_score(flat_scores, keep, out_top)
    out_boxes = take_rows(flat_boxes, idx)
    out_scores = torch.gather(flat_scores, 1, idx)
    return (out_boxes, out_scores, class_ids[idx], out_valid, roi_dropped,
            roi_truncated)


def resized_shape(h, w, rmin=800, rmax=1333):
    scl = min(rmin / min(h, w), rmax / max(h, w))
    return int(h * scl + 0.5), int(w * scl + 0.5)


def canvas_shape(nh, nw, mult=32):
    return (-(-nh // mult) * mult, -(-nw // mult) * mult)


def preprocess(frames_u8, resized_hw, canvas_hw, compute_dtype=None, orig_hw=None):
    """uint8 BGR frames [B, H, W, 3] -> the normalized RGB canvas, NCHW.

    With ``compute_dtype`` (bf16 throughput mode) and frames not resized on
    the host: resize straight from uint8 onto the zero canvas, then one
    masked normalize (the ImageNet shift must not leak into the pad) — the
    channel flip and the affine commute with the resize. Otherwise: flip,
    resize, normalize, pad (``models/rcnn.py:303-319`` of the JAX package).
    ``orig_hw`` set: the frames were already resized on the host."""
    nh, nw = resized_hw
    dev = frames_u8.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    if compute_dtype is not None and orig_hw is None:
        x = bilinear_resize_matmul(frames_u8, (nh, nw), canvas_hw=canvas_hw)
        rows = torch.arange(canvas_hw[0], device=dev)[:, None] < nh
        cols = torch.arange(canvas_hw[1], device=dev)[None, :] < nw
        norm = (x.flip(-1) - mean) / std
        x = torch.where((rows & cols)[..., None], norm, torch.zeros_like(norm))
        x = x.to(compute_dtype)
    else:
        x = frames_u8.flip(-1).to(torch.float32)
        if orig_hw is None:
            x = bilinear_resize_matmul(x, (nh, nw))
        x = (x - mean) / std
        x = torch.nn.functional.pad(x, (0, 0, 0, canvas_hw[1] - nw, 0, canvas_hw[0] - nh))
        if compute_dtype is not None:
            x = x.to(compute_dtype)
    return x.permute(0, 3, 1, 2)     # channels-last storage, NCHW view


def full_forward(model, frames_u8, resized_hw, canvas_hw, priors_per_level,
                 out_top=100, proposal_cap=1000, orig_hw=None, compute_dtype=None):
    """uint8 BGR frames [B, H, W, 3] -> final detections in original-frame
    coordinates: (boxes [B, out_top, 4], scores, classes, valid,
    select_overflow [B], roi_dropped [B], roi_truncated [B]) — the JAX
    package's seven outputs. ``model`` is an ``AnimeFRCNN`` whose parameters
    are in ``compute_dtype`` (None = float32); ``orig_hw``: set when the
    frames were already resized on the host; ``priors_per_level``: per-level
    [D_l, 4] tensors of ``get_priors(canvas_hw, frcnn_bases(),
    loc="corner", concat=False)``."""
    if orig_hw is None:
        h, w = frames_u8.shape[1:3]
    else:
        h, w = orig_hw
    nh, nw = resized_hw
    x = preprocess(frames_u8, resized_hw, canvas_hw, compute_dtype, orig_hw)
    pyramid, regs, logs = model.body(x)
    regs = [t.float() for t in regs]
    logs = [t.float() for t in logs]
    used = torch.tensor([[nh, nw]], dtype=torch.float32, device=x.device).repeat(x.shape[0], 1)
    proposals, pvalid, select_overflow = rpn_proposals(
        regs, logs, priors_per_level, used, lvtop=proposal_cap, out_top=proposal_cap)

    def apply_head(roi_maps):
        if compute_dtype is not None:
            roi_maps = roi_maps.to(compute_dtype)
        reg, cls = model.head(roi_maps)
        return reg.float(), cls.float()

    boxes, scores, classes, valid, roi_dropped, roi_truncated = roi_detections(
        apply_head, pyramid, proposals, pvalid, used, model.num_classes, out_top=out_top)
    scale = torch.tensor([w / nw, h / nh, w / nw, h / nh], dtype=torch.float32,
                         device=x.device)
    return (boxes * scale, scores, classes, valid, select_overflow, roi_dropped,
            roi_truncated)


