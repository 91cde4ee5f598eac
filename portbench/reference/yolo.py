"""The plain reference of YOLOv3 (Redmon and Farhadi, arXiv:1804.02767) for
the benchmark: Darknet-53, the FPN-style neck and the 3-level head in the
mmdetection layout of the original project's ``detectors/yolo.py:17-176``
(1 class), then its postprocess, in plain float32 PyTorch with TF32 off.
It imports nothing of the program or of JAX; the module names are the
program's (``backbone.stage{i}_res{j}.conv1.conv.weight``, ...), so one
seeded state loads into both.

A forward: BGR -> RGB, keep-ratio bilinear resize to ``max_side`` (two
interpolation-matrix products, half-pixel, edge-clamped), ``* f32(1/255)``,
zero pad to the /32 canvas; backbone, neck, head; per (location, anchor)
objectness sigmoid(o) and class score sigmoid(c), a candidate where
objectness >= ``conf_thr`` and class score > ``score_thr``, scored
objectness x class score; the ``pre_topk`` best by an exact stable
descending sort (lower flat index first among equal scores); boxes
decoded in yolo mode (xy = stride x (sigmoid(t_xy) - 0.5) + prior, wh =
prior_wh x exp(t_wh)); greedy NMS at IoU ``iou_thr`` per image, grouped by
class; the ``out_topk`` best kept; boxes scaled to the frame.

Departures from the original ``detectors/yolo.py``, all shared with the
program:

- the resize runs on the device as two matrix products instead of the
  host's cv2 ``INTER_LINEAR`` (cv2 rounds its weights to fixed point);
- at most ``pre_topk`` (1,000) candidates per image enter NMS, the best by
  score (the original sends every candidate to NMS);
- ties in score are broken by the lower flat index (level 32 -> 16 -> 8,
  row-major, anchor-minor), where torchvision's sort and NMS leave the
  order unspecified;
- outputs are fixed-capacity buffers of ``out_topk`` rows with a validity
  mask instead of variable-length lists.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .anchors import get_priors
from .boxes import decode_boxes
from .layers import ConvUnit
from .nms import nms_keep_mask, take_rows, topk_by_score
from .resize import bilinear_resize_matmul

BASES = [
    (32, [(116, 90), (156, 198), (373, 326)]),
    (16, [(30, 61), (62, 45), (59, 119)]),
    (8, [(10, 13), (16, 30), (33, 23)]),
]
INV_255 = float(np.float32(1.0 / 255.0))

# float32 products on the card: cuBLAS and cuDNN would otherwise be free to
# round their operands to TF32 (the control, ``precision.tf32``, turns both
# flags on around its own calls)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def dconv(cin, cout, k, s=1):
    """Darknet's unit: conv (no bias) + BatchNorm eps 1e-5 + leaky ReLU 0.1."""
    return ConvUnit(cin, cout, k, s, (k - 1) // 2, "lrelu_0.1", 1e-5)


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = dconv(c, c // 2, 1)
        self.conv2 = dconv(c // 2, c, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class Darknet53(nn.Module):
    """(1, 2, 8, 8, 4) residual blocks at 64-1,024 channels; returns the
    maps at strides 8, 16 and 32."""

    COUNTS = (1, 2, 8, 8, 4)
    CHANS = (64, 128, 256, 512, 1024)

    def __init__(self):
        super().__init__()
        self.conv1 = dconv(3, 32, 3)
        cin = 32
        for i, (n, c) in enumerate(zip(self.COUNTS, self.CHANS)):
            self.add_module(f"stage{i}_down", dconv(cin, c, 3, 2))
            for j in range(n):
                self.add_module(f"stage{i}_res{j}", ResBlock(c))
            cin = c

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for i, n in enumerate(self.COUNTS):
            x = getattr(self, f"stage{i}_down")(x)
            for j in range(n):
                x = getattr(self, f"stage{i}_res{j}")(x)
            outs.append(x)
        return outs[2], outs[3], outs[4]


class DetectionBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.c0 = dconv(cin, cout, 1)
        self.c1 = dconv(cout, cout * 2, 3)
        self.c2 = dconv(cout * 2, cout, 1)
        self.c3 = dconv(cout, cout * 2, 3)
        self.c4 = dconv(cout * 2, cout, 1)

    def forward(self, x):
        return self.c4(self.c3(self.c2(self.c1(self.c0(x)))))


class YOLOv3Neck(nn.Module):
    """Detection blocks at 512 / 256 / 128 channels, top down: stride 32,
    then x2 nearest upsampling and concatenation at 16 and 8."""

    def __init__(self):
        super().__init__()
        self.detect1 = DetectionBlock(1024, 512)
        self.conv1 = dconv(512, 256, 1)
        self.detect2 = DetectionBlock(256 + 512, 256)
        self.conv2 = dconv(256, 128, 1)
        self.detect3 = DetectionBlock(128 + 256, 128)

    def forward(self, c3, c4, c5):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        y3 = self.detect1(c5)
        y2 = self.detect2(torch.cat([up(self.conv1(y3)), c4], dim=1))
        y1 = self.detect3(torch.cat([up(self.conv2(y2)), c3], dim=1))
        return y3, y2, y1


class YOLOv3Head(nn.Module):
    """3x3 bridges to 1,024 / 512 / 256 channels, then a 1x1 prediction of
    3 anchors x (4 box, 1 objectness, ``num_classes`` class) channels."""

    def __init__(self, num_classes=1):
        super().__init__()
        cout = (num_classes + 5) * 3
        for i, (cin, cmid) in enumerate(zip((512, 256, 128), (1024, 512, 256))):
            self.add_module(f"bridge{i}", dconv(cin, cmid, 3))
            self.add_module(f"pred{i}", nn.Conv2d(cmid, cout, 1))

    def forward(self, y3, y2, y1):
        return [getattr(self, f"pred{i}")(getattr(self, f"bridge{i}")(y))
                for i, y in enumerate((y3, y2, y1))]       # strides 32, 16, 8


class YOLOv3(nn.Module):
    """The three NCHW head maps [B, 3 * (5 + nc), H / s, W / s], s = 32,
    16, 8."""

    def __init__(self, num_classes=1):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = Darknet53()
        self.neck = YOLOv3Neck()
        self.head = YOLOv3Head(num_classes)

    def forward(self, x):
        return self.head(*self.neck(*self.backbone(x)))


def flat_priors_and_strides(canvas_hw):
    """Priors [D, 4] and strides [D, 1] (float32 numpy) in the flat order of
    the head maps: level 32 -> 16 -> 8, row-major, anchor-minor."""
    per_level = get_priors(canvas_hw, BASES, loc="center", concat=False)
    strides = [np.full((len(p), 1), s, np.float32) for s, p in zip((32, 16, 8), per_level)]
    return np.concatenate(per_level), np.concatenate(strides)


def resized_shape(h, w, max_side=608):
    scl = min(max_side / min(h, w), max_side / max(h, w))
    return int(h * scl + 0.5), int(w * scl + 0.5)


def canvas_shape(nh, nw, mult=32):
    return (-(-nh // mult) * mult, -(-nw // mult) * mult)


def preprocess(frames_u8, resized_hw, canvas_hw):
    """uint8 BGR [B, H, W, 3] -> the RGB / 255 canvas, NCHW (channels-last
    storage, as the program lays it out)."""
    nh, nw = resized_hw
    x = bilinear_resize_matmul(frames_u8.flip(-1).to(torch.float32), (nh, nw))
    x = F.pad(x * INV_255, (0, 0, 0, canvas_hw[1] - nw, 0, canvas_hw[0] - nh))
    return x.permute(0, 3, 1, 2)


def flat_maps(maps, num_classes=1):
    """Head maps -> [B, D, 5 + nc] in the flat candidate order."""
    b = maps[0].shape[0]
    return torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, num_classes + 5) for m in maps], 1)


def candidates(flat, conf_thr=0.005, score_thr=0.05):
    """[B, D, 5 + nc] -> the candidates' scores [B, D * nc], 0 where the
    (location, class) is no candidate."""
    obj = torch.sigmoid(flat[..., 4])
    cls = torch.sigmoid(flat[..., 5:])
    ok = (obj[..., None] >= conf_thr) & (cls > score_thr)
    return torch.where(ok, cls * obj[..., None], torch.zeros_like(cls)).reshape(len(flat), -1)


def detect_flat(flat, priors, strides, conf_thr=0.005, score_thr=0.05, iou_thr=0.45,
                pre_topk=1000, out_topk=100):
    """Flat head maps [B, D, 5 + nc] -> (boxes [B, out_topk, 4] canvas
    coordinates, scores, classes, valid) and the valid candidates entering
    NMS per image."""
    nc = flat.shape[-1] - 5
    scores = candidates(flat, conf_thr, score_thr)
    k = min(pre_topk, scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    valid = top > 0.0
    loc, cls = idx // nc, idx % nc
    boxes = decode_boxes(take_rows(flat[..., :4], loc), priors[loc], mode="yolo",
                         strides=strides[loc])
    keep = nms_keep_mask(boxes, top, valid, iou_thr, group_ids=cls)
    sel, out_valid = topk_by_score(top, keep, min(out_topk, k))
    out_scores = torch.where(out_valid, torch.gather(top, 1, sel), torch.zeros_like(top[:, :1]))
    return (take_rows(boxes, sel), out_scores, torch.gather(cls, 1, sel), out_valid,
            valid.sum(1))


def geometry(h, w, max_side, device):
    """(resized size, canvas, priors [D, 4], strides [D, 1] on ``device``)
    of an h x w frame."""
    nh, nw = resized_shape(h, w, max_side)
    canvas = canvas_shape(nh, nw)
    priors, strides = (torch.from_numpy(a).to(device) for a in flat_priors_and_strides(canvas))
    return (nh, nw), canvas, priors, strides


def full_forward(model, frames_u8, max_side=608, **post):
    """uint8 BGR frames [B, H, W, 3] -> (boxes [B, out_topk, 4] in frame
    coordinates, scores, classes, valid, candidates [B]); ``post``: the
    thresholds and capacities of ``detect_flat``."""
    h, w = frames_u8.shape[1:3]
    (nh, nw), canvas, priors, strides = geometry(h, w, max_side, frames_u8.device)
    maps = model(preprocess(frames_u8, (nh, nw), canvas))
    boxes, scores, classes, valid, n = detect_flat(flat_maps(maps, model.num_classes), priors,
                                                   strides, **post)
    scale = torch.tensor([w / nw, h / nh, w / nw, h / nh], dtype=torch.float32,
                         device=boxes.device)
    return boxes * scale, scores, classes, valid, n
