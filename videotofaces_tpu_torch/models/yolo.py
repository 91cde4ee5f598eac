"""YOLOv3 face detector, Darknet-53 + FPN-style neck + 3-level head
(counterpart of videotofaces_tpu/models/yolo.py).

Architecture parity target: detectors/yolo.py:17-176 of the reference
(mmdetection-style YOLOv3, num_classes=1, WIDER-face weights). As in the JAX
package, the dynamic-size tail is a fixed-capacity buffer with a validity
mask: uint8 frames -> keep-ratio resize onto a /32 canvas -> RGB / 255 ->
backbone / neck / head -> sigmoid scores, joint (objectness, class-score)
mask, top-``pre_topk`` selection, per-image greedy NMS grouped by class ->
top ``out_topk``.

Differences from the JAX package, by design:
- the candidate selection is an exact stable descending sort carrying the
  payload (the JAX package's ``block_topk_select(per_block=20)`` can drop
  candidates when a 128-lane block holds more than its share of the top
  ``pre_topk``, as at 1080p; it counts them in ``overflow``). The port's
  ``overflow`` is 0, and its outputs equal the JAX package's wherever the
  JAX ``overflow`` is 0;
- the TPU layout arms (``s2d_stem``, ``PackedDown``, the space-to-depth
  resize) are not ported: they compute the same taps in another blocking.

Maps are NCHW inside the modules; ``postprocess`` reorders the head maps to
the JAX package's flat candidate order (level 32 -> 16 -> 8, row-major,
anchor-minor), the order of ``flat_priors_and_strides``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.anchors import get_priors
from ..ops.boxes import decode_boxes
from ..ops.nms import nms_keep_mask, take_rows, topk_by_score
from ..ops.resize import bilinear_resize_matmul
from ..utils.weights import yolo_from_jax
from .layers import ConvUnit, init_uniform_fan_in_

BASES = [
    (32, [(116, 90), (156, 198), (373, 326)]),
    (16, [(30, 61), (62, 45), (59, 119)]),
    (8, [(10, 13), (16, 30), (33, 23)]),
]
# jitted JAX computes ``x / 255.0`` as the product with the float32 reciprocal
INV_255 = float(np.float32(1.0 / 255.0))


def dconv(cin, cout, k, s=1):
    """Darknet's ConvUnit: conv (no bias) + BatchNorm eps 1e-5 + leaky ReLU 0.1."""
    return ConvUnit(cin, cout, k, s, (k - 1) // 2, "lrelu_0.1", 1e-5)


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = dconv(c, c // 2, 1)
        self.conv2 = dconv(c // 2, c, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class Darknet53(nn.Module):
    """Returns (C3, C4, C5) at strides (8, 16, 32)."""

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


def _upsample2(x):
    """Exact nearest-neighbour x2 upsampling of NCHW maps."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv3Neck(nn.Module):
    """Top-down feature aggregation: detect @32, upsample-concat @16, @8."""

    def __init__(self):
        super().__init__()
        self.detect1 = DetectionBlock(1024, 512)
        self.conv1 = dconv(512, 256, 1)
        self.detect2 = DetectionBlock(256 + 512, 256)
        self.conv2 = dconv(256, 128, 1)
        self.detect3 = DetectionBlock(128 + 256, 128)

    def forward(self, c3, c4, c5):
        y3 = self.detect1(c5)
        t = torch.cat([_upsample2(self.conv1(y3)), c4], dim=1)
        y2 = self.detect2(t)
        t = torch.cat([_upsample2(self.conv2(y2)), c3], dim=1)
        y1 = self.detect3(t)
        return y3, y2, y1


class YOLOv3Head(nn.Module):
    def __init__(self, num_classes=1):
        super().__init__()
        cout = (num_classes + 5) * 3
        for i, (cin, cmid) in enumerate(zip((512, 256, 128), (1024, 512, 256))):
            self.add_module(f"bridge{i}", dconv(cin, cmid, 3))
            self.add_module(f"pred{i}", nn.Conv2d(cmid, cout, 1))

    def forward(self, y3, y2, y1):
        return [getattr(self, f"pred{i}")(getattr(self, f"bridge{i}")(y))
                for i, y in enumerate((y3, y2, y1))]       # strides (32, 16, 8)


class YOLOv3(nn.Module):
    """The JAX package's ``{"backbone", "neck", "head"}`` tree; returns the
    three NCHW head maps [B, 3 * (5 + nc), H / s, W / s], s = 32, 16, 8."""

    def __init__(self, num_classes=1):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = Darknet53()
        self.neck = YOLOv3Neck()
        self.head = YOLOv3Head(num_classes)

    def forward(self, x):
        return self.head(*self.neck(*self.backbone(x)))

    @classmethod
    def from_jax(cls, params_np, num_classes=1):
        """Build from the JAX package's {"backbone", "neck", "head"} tree
        (numpy arrays)."""
        model = cls(num_classes)
        model.load_state_dict(yolo_from_jax(params_np), strict=True)
        return model

    @classmethod
    def seeded(cls, seed=0, num_classes=1):
        """Random weights from an explicit ``torch.Generator``: conv weights
        and the heads' biases uniform in +-1/sqrt(fan_in); BatchNorm scale
        1, bias 0, mean 0, var 1."""
        return init_uniform_fan_in_(cls(num_classes), seed)


def flat_priors_and_strides(canvas_hw):
    """Concatenated priors [D, 4] and per-candidate strides [D, 1] (float32
    numpy) in the flat order of the head maps (level 32 -> 16 -> 8,
    row-major, anchor-minor)."""
    per_level = get_priors(canvas_hw, BASES, loc="center", concat=False)
    priors = np.concatenate(per_level)
    strides = np.concatenate([np.full((lvl.shape[0], 1), s, np.float32)
                              for s, lvl in zip((32, 16, 8), per_level)])
    return priors, strides


def resized_shape(h, w, max_side=608):
    scl = min(max_side / min(h, w), max_side / max(h, w))
    return int(h * scl + 0.5), int(w * scl + 0.5)


def canvas_shape(nh, nw, mult=32):
    return (-(-nh // mult) * mult, -(-nw // mult) * mult)


def select_candidates(maps, num_classes=1, conf_thr=0.005, score_thr=0.05,
                      pre_topk=1000):
    """The top ``pre_topk`` (location, class) candidates of a batch of NCHW
    head maps: (scores [B, k] descending, with 0 for slots past the valid
    ones; flat indices [B, k] into D * nc, location = index // nc, class =
    index % nc; the regression outputs [B, D, 4]). A candidate has
    objectness >= ``conf_thr`` and class score > ``score_thr``; its score is
    obj * cls (yolo.py:151-175). Exact stable descending sort: lower index
    first among equal scores."""
    b = maps[0].shape[0]
    nc = num_classes
    flat = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, nc + 5) for m in maps],
                     dim=1)                                   # [B, D, 5 + nc]
    obj = torch.sigmoid(flat[..., 4])
    cls = torch.sigmoid(flat[..., 5:])
    ok = (obj[..., None] >= conf_thr) & (cls > score_thr)
    masked = torch.where(ok, cls * obj[..., None], torch.zeros_like(cls)).reshape(b, -1)
    k = min(pre_topk, masked.shape[1])
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k], flat[..., :4]


def postprocess(maps, priors, strides, num_classes=1, conf_thr=0.005, score_thr=0.05,
                iou_thr=0.45, pre_topk=1000, out_topk=100):
    """Fixed-capacity postprocessing of one batch of NCHW head maps
    (``priors`` [D, 4], ``strides`` [D, 1] tensors from
    ``flat_priors_and_strides``): ``select_candidates``, decode, greedy NMS
    per image grouped by class, top ``out_topk`` by kept score.

    Returns (boxes [B, out_topk, 4] canvas coords, scores, classes (int32),
    valid, overflow [B] int32 — always 0: the selection is exact)."""
    nc = num_classes
    top_scores, idx, reg = select_candidates(maps, nc, conf_thr, score_thr, pre_topk)
    out_topk = min(out_topk, top_scores.shape[1])
    loc = idx // nc
    class_id = (idx % nc).to(torch.int32)
    valid = top_scores > 0.0
    boxes = decode_boxes(take_rows(reg, loc), priors[loc], mode="yolo",
                         strides=strides[loc])                 # [B, k, 4]
    keep = nms_keep_mask(boxes, None, valid, iou_thr, class_id, presorted=True)
    sel, out_valid = topk_by_score(top_scores, keep, out_topk)
    out_scores = torch.where(out_valid, torch.gather(top_scores, 1, sel),
                             torch.zeros_like(top_scores[:, :out_topk]))
    overflow = torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)
    return (take_rows(boxes, sel), out_scores, torch.gather(class_id, 1, sel), out_valid,
            overflow)


def preprocess(frames_u8, resized_hw, canvas_hw, compute_dtype=None, orig_hw=None):
    """uint8 BGR frames [B, H, W, 3] -> the RGB / 255 canvas, NCHW.

    With ``compute_dtype`` (bf16 throughput mode) and frames not resized on
    the host: resize straight from uint8 onto the zero canvas, then flip to
    RGB and scale (both commute with the resize). Otherwise: flip, resize,
    scale, pad (``models/yolo.py:419-435`` of the JAX package). ``orig_hw``
    set: the frames were already resized on the host."""
    nh, nw = resized_hw
    if compute_dtype is not None and orig_hw is None:
        x = bilinear_resize_matmul(frames_u8, (nh, nw), canvas_hw=canvas_hw)
        x = (x.flip(-1) * INV_255).to(compute_dtype)
    else:
        x = frames_u8.flip(-1).to(torch.float32)
        if orig_hw is None:
            x = bilinear_resize_matmul(x, (nh, nw))
        x = F.pad(x * INV_255, (0, 0, 0, canvas_hw[1] - nw, 0, canvas_hw[0] - nh))
        if compute_dtype is not None:
            x = x.to(compute_dtype)
    return x.permute(0, 3, 1, 2)     # channels-last storage, NCHW view


def full_forward(model, frames_u8, resized_hw, canvas_hw, priors, strides,
                 out_topk=100, orig_hw=None, compute_dtype=None):
    """uint8 BGR frames [B, H, W, 3] -> final detections in original-frame
    coordinates: (boxes [B, out_topk, 4], scores, classes, valid, overflow
    [B]) — the JAX package's five outputs (yolo.py:139-147: keep-ratio
    resize to ``max_side``, /255, RGB, zero pad to the /32 canvas). ``model``
    is a ``YOLOv3`` whose parameters are in ``compute_dtype`` (None =
    float32); ``orig_hw``: set when the frames were already resized on the
    host; ``priors`` / ``strides``: ``flat_priors_and_strides(canvas_hw)``
    as tensors on the frames' device."""
    if orig_hw is None:
        h, w = frames_u8.shape[1:3]
    else:
        h, w = orig_hw
    nh, nw = resized_hw
    x = preprocess(frames_u8, resized_hw, canvas_hw, compute_dtype, orig_hw)
    maps = [m.float() for m in model(x)]
    boxes, scores, classes, valid, overflow = postprocess(
        maps, priors, strides, model.num_classes, out_topk=out_topk)
    scale = torch.tensor([w / nw, h / nh, w / nw, h / nh], dtype=torch.float32,
                         device=boxes.device)
    return boxes * scale, scores, classes, valid, overflow


def torch_spec(num_classes=1):
    """Ordered checkpoint spec matching the torch reference's registration
    order (detectors/yolo.py:34-120): Darknet53, neck, head (bridges then
    preds), with the JAX layout's paths, which ``YOLOv3.from_jax`` reads.
    Used by the converter (``videotofaces_tpu_torch.convert_weights``) for
    the positional .pt remap."""
    from ..utils import weights as W

    els = []
    els += W.convunit("backbone/conv1")
    for i, n in enumerate([1, 2, 8, 8, 4]):
        els += W.convunit(f"backbone/stage{i}_down")
        for j in range(n):
            els += W.convunit(f"backbone/stage{i}_res{j}/conv1")
            els += W.convunit(f"backbone/stage{i}_res{j}/conv2")
    for block, cv in [("detect1", "conv1"), ("detect2", "conv2"), ("detect3", None)]:
        for c in range(5):
            els += W.convunit(f"neck/{block}/c{c}")
        if cv:
            els += W.convunit(f"neck/{cv}")
    for i in range(3):
        els += W.convunit(f"head/bridge{i}")
    for i in range(3):
        els.append(W.conv(f"head/pred{i}", bias=True))
    return els
