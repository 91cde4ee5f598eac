"""Frozen copy of the port's models/mtcnn.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .nms import iom_chain_suppress, nms_keep_mask_bucketed, take_rows, topk_by_score
from .resize import adaptive_pool_boxes_batched, adaptive_pool_full, integral_image, normalize
from .layers import PConv, PReLU


def pnet_level(frames_u8, level_hw, pnet):
    """PNet over one pyramid level: the exact integral-image pool of the
    RGB frames, normalized, then the module's convolutions (float32)."""
    h, w = frames_u8.shape[1:3]
    ii = integral_image(frames_u8.flip(-1))
    lvl = normalize(adaptive_pool_full(ii, level_hw, (h, w)))
    return pnet(lvl.permute(0, 3, 1, 2).contiguous())


def pool_crops(frames_u8, slots, out_size):
    """The crop resample of stages 2 and 3: slots [N, 6] int32 (img, y0,
    x0, h, w, ok) -> [N, out, out, 3] float32 normalized RGB crops, zero for
    dead slots (integral-image corner gathers per slot)."""
    b, h, w = frames_u8.shape[:3]
    img, y0, x0, wh, ww, ok = slots.unbind(1)
    live = ((ok != 0) & (img >= 0) & (img < b) & (y0 >= 0) & (x0 >= 0)
            & (wh > 0) & (ww > 0) & (y0 <= h - wh) & (x0 <= w - ww))
    win = torch.stack([x0, y0, x0 + ww, y0 + wh], dim=1)
    unit = torch.tensor([0, 0, 1, 1], dtype=win.dtype, device=win.device)
    win = torch.where(live[:, None], win, unit)
    imgidx = torch.where(live, img, torch.zeros_like(img))
    ii = integral_image(frames_u8.flip(-1))
    crops = normalize(adaptive_pool_boxes_batched(ii, win, imgidx, (out_size, out_size)))
    return torch.where(live[:, None, None, None], crops, torch.zeros_like(crops))


def _flatten_whc(x):
    """torch's permute(0, 3, 2, 1) + flatten of an NCHW map: (w, h, c) order
    (reference mtcnn.py:68), so the JAX Dense weights carry over as they are."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Fully-convolutional proposal net: 12x12 receptive field, stride 2.
    The cascade runs ``forward`` on each pooled level; ``forward``
    is the module form (NCHW in, (reg [B, 4, h, w], prob [B, h, w]) out)."""

    def __init__(self):
        super().__init__()
        self.conv1 = PConv(3, 10, 3)
        self.conv2 = PConv(10, 16, 3)
        self.conv3 = PConv(16, 32, 3)
        self.cls = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 2, 2, ceil_mode=True)
        x = self.conv3(self.conv2(x))
        prob = torch.softmax(self.cls(x), dim=1)[:, 1]
        return self.reg(x), prob


class RNet(nn.Module):
    """24x24 refinement net: NCHW crops -> (reg [N, 4], prob [N])."""

    def __init__(self):
        super().__init__()
        self.conv1 = PConv(3, 28, 3)
        self.conv2 = PConv(28, 48, 3)
        self.conv3 = PConv(48, 64, 2)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = PReLU(128)
        self.cls = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.conv2(x), 3, 2, ceil_mode=True)
        x = self.prelu4(self.dense4(_flatten_whc(self.conv3(x))))
        return self.reg(x), torch.softmax(self.cls(x), dim=1)[:, 1]


class ONet(nn.Module):
    """48x48 output net with landmark head: NCHW crops -> (reg [N, 4],
    lmk [N, 10], prob [N])."""

    def __init__(self):
        super().__init__()
        self.conv1 = PConv(3, 32, 3)
        self.conv2 = PConv(32, 64, 3)
        self.conv3 = PConv(64, 64, 3)
        self.conv4 = PConv(64, 128, 2)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = PReLU(256)
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.lmk = nn.Linear(256, 10)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.conv2(x), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.conv3(x), 2, 2, ceil_mode=True)
        x = self.prelu5(self.dense5(_flatten_whc(self.conv4(x))))
        return self.reg(x), self.lmk(x), torch.softmax(self.cls(x), dim=1)[:, 1]


class MTCNN(nn.Module):
    """The three nets of the cascade."""

    def __init__(self):
        super().__init__()
        self.pnet = PNet()
        self.rnet = RNet()
        self.onet = ONet()

@dataclass(frozen=True)
class Caps:
    """Fixed buffer capacities for the cascade (per image), as in the JAX
    package. The JAX crop engine's bucket caps (``crops_mid``/``crops_big``)
    have no counterpart: the port's crop kernel has no size buckets."""

    pre1: int = 1024     # stage-1 pre-NMS candidates per scale
    post1: int = 512     # stage-1 post-NMS keeps per scale
    cross: int = 2048    # cross-scale NMS input
    stage2: int = 1024   # RNet candidates
    stage3: int = 256    # ONet candidates
    out: int = 128       # final detections


def scale_pyramid(h, w, minsize, factor=0.709):
    """Host: geometric scale list and resampled sizes (mtcnn.py:141-148)."""
    scales = []
    s = 12.0 / minsize
    while min(h, w) * s >= 12:
        scales.append(s)
        s *= factor
    sizes = [(int(h * sc + 1), int(w * sc + 1)) for sc in scales]
    return scales, sizes


def refine_bbox(boxes, pred, plus_one):
    off = 1.0 if plus_one else 0.0
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    return boxes + pred * torch.stack([w, h, w, h], dim=-1)


def square_bbox(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.stack([x1, y1, x1 + side, y1 + side], dim=-1)


def _crop_windows(boxes, img_hw):
    """Integer crop windows with the reference's clamping (mtcnn.py:157-160):
    x1 = max(1, int(x1)) ... x2 = min(W, int(x2)); the window spans
    [y1-1 : y2, x1-1 : x2]. Returns (windows [N, 4] int32 (x1, y1, x2, y2),
    ok [N])."""
    h, w = img_hw
    i = lambda t: t.to(torch.int32)
    x1 = torch.clamp(i(boxes[..., 0]), min=1)
    y1 = torch.clamp(i(boxes[..., 1]), min=1)
    x2 = torch.clamp(i(boxes[..., 2]), max=w)
    y2 = torch.clamp(i(boxes[..., 3]), max=h)
    ok = (y2 > y1 - 1) & (x2 > x1 - 1)
    z, one = torch.zeros_like(x1), torch.ones_like(x1)
    win = torch.stack([torch.where(ok, x1 - 1, z), torch.where(ok, y1 - 1, z),
                       torch.where(ok, x2, one), torch.where(ok, y2, one)], dim=-1)
    return win, ok


def _per_image_nms(boxes, scores, valid, thr):
    return nms_keep_mask_bucketed(boxes, scores, valid, thr)


def _select_topk(scores, keep, k, *arrays):
    idx, valid = topk_by_score(scores, keep, k)
    return (valid, *(take_rows(a, idx) for a in arrays))


def full_forward(model, frames_u8, minsize=20, caps=Caps(),
                 thresholds=(0.6, 0.7, 0.7), factor=0.709, compute_dtype=None,
                 stage1_nms=None):
    """uint8 BGR frames [B, H, W, 3] -> (boxes [B, out, 4], scores [B, out],
    landmarks [B, out, 5, 2], valid [B, out], counts) — the JAX contract.
    ``counts`` holds [B] int32 totals under every key of the JAX cascade:
    stage1, stage1_scale_max, stage1_select_overflow, cross_in, stage2,
    stage2_crop_dropped, stage3, stage3_crop_dropped.

    ``model`` is an ``MTCNN``; RNet and ONet run in their parameters' dtype
    on crops rounded to ``compute_dtype`` (None = float32), and PNet computes
    in ``compute_dtype``. ``stage1_nms``: ``"level"`` (default) runs one NMS
    per pyramid level, ``"stacked"`` one batched NMS over every level's
    buffer — exact either way."""
    b, h, w = frames_u8.shape[:3]
    dev = frames_u8.device
    t1, t2, t3 = thresholds
    scales, sizes = scale_pyramid(h, w, minsize, factor)
    kdt = compute_dtype if compute_dtype is not None else torch.float32
    stage1_nms = stage1_nms or "level"
    if stage1_nms not in ("level", "stacked"):
        raise ValueError("unknown stage1_nms %r (want 'level', 'stacked', or "
                         "None for the default)" % (stage1_nms,))
    frames_u8 = frames_u8.contiguous()
    zeros_b = torch.zeros((b,), dtype=torch.int32, device=dev)
    counts = {}

    # ---- stage 1: proposal network over the pyramid -------------------------
    s_boxes, s_scores, s_preds, s_valid = [], [], [], []
    total_cand, scale_max = zeros_b, zeros_b
    for sc, level_hw in zip(scales, sizes):
        reg_m, prob_m = pnet_level(frames_u8, level_hw, model.pnet)
        ph, pw = prob_m.shape[1:]
        d = ph * pw
        flat_prob = prob_m.reshape(b, d)
        masked = torch.where(flat_prob >= t1, flat_prob, torch.zeros_like(flat_prob))
        level_cand = (masked > 0).sum(dim=1).to(torch.int32)
        total_cand = total_cand + level_cand
        scale_max = torch.maximum(scale_max, level_cand)
        k1 = min(caps.pre1, d)
        scores, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        scores, idx = scores[:, :k1], idx[:, :k1]
        valid = scores >= t1
        wi, hi = (idx % pw).float(), (idx // pw).float()
        # (2 * x + 1) / scale as the JAX package's compiled cascade computes
        # it: XLA turns the division by the constant scale into a product
        # with its float32 reciprocal, and floor() makes the difference a
        # whole pixel at some positions
        inv = (torch.tensor(1.0, dtype=torch.float32)
               / torch.tensor(sc, dtype=torch.float32)).to(dev)
        boxes = torch.stack([
            torch.floor((2.0 * wi + 1.0) * inv), torch.floor((2.0 * hi + 1.0) * inv),
            torch.floor((2.0 * wi + 12.0) * inv), torch.floor((2.0 * hi + 12.0) * inv),
        ], dim=-1)                                                # [B, k1, 4]
        preds = torch.gather(reg_m.reshape(b, 4, d), 2,
                             idx[:, None, :].expand(b, 4, k1)).transpose(1, 2).float()
        if stage1_nms == "level":
            keep = _per_image_nms(boxes, scores, valid, 0.5)
            valid, boxes, scores, preds = _select_topk(
                scores, keep, min(caps.post1, k1), boxes, scores, preds)
        s_boxes.append(boxes)
        s_scores.append(scores)
        s_preds.append(preds)
        s_valid.append(valid)
    counts["stage1"] = total_cand
    counts["stage1_scale_max"] = scale_max   # pre1 caps each scale, not the total
    counts["stage1_select_overflow"] = zeros_b   # exact top-k: never truncates

    if stage1_nms == "stacked":
        # one [B*L, K] problem set: rows are independent (image, level) NMS
        # problems, padded with invalid slots that can never be kept
        nl, kmax = len(s_scores), max(a.shape[1] for a in s_scores)

        def stack(arrs):
            padded = [torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2)
                                              + (0, kmax - a.shape[1])) for a in arrs]
            return torch.stack(padded, dim=1).reshape((b * nl, kmax) + arrs[0].shape[2:])

        bx, sc_, pr, vl = (stack(a) for a in (s_boxes, s_scores, s_preds, s_valid))
        keep = _per_image_nms(bx, sc_, vl, 0.5)
        k1p = min(caps.post1, kmax)
        vl, bx, sc_, pr = _select_topk(sc_, keep, k1p, bx, sc_, pr)
        boxes, scores = bx.reshape(b, nl * k1p, 4), sc_.reshape(b, nl * k1p)
        preds, valid = pr.reshape(b, nl * k1p, 4), vl.reshape(b, nl * k1p)
    else:
        boxes, scores = torch.cat(s_boxes, dim=1), torch.cat(s_scores, dim=1)
        preds, valid = torch.cat(s_preds, dim=1), torch.cat(s_valid, dim=1)
    # survivors entering the cross-scale stage; caps.cross truncates here
    counts["cross_in"] = valid.sum(dim=1).to(torch.int32)
    if boxes.shape[1] > caps.cross:
        ninf = torch.full_like(scores, float("-inf"))
        valid, boxes, scores, preds = _select_topk(
            torch.where(valid, scores, ninf), valid, caps.cross, boxes, scores, preds)

    keep = _per_image_nms(boxes, scores, valid, 0.7)
    valid, boxes, scores, preds = _select_topk(
        scores, keep, min(caps.stage2, boxes.shape[1]), boxes, scores, preds)
    boxes = square_bbox(refine_bbox(boxes, preds, plus_one=False))

    def run_subnet(module, boxes, valid, size):
        k = boxes.shape[1]
        win, ok = _crop_windows(boxes.reshape(b * k, 4), (h, w))
        imgidx = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(k)
        live = ok & valid.reshape(b * k)   # dead slots cost the kernel nothing
        slots = torch.stack([imgidx, win[:, 1], win[:, 0], win[:, 3] - win[:, 1],
                             win[:, 2] - win[:, 0], live.to(torch.int32)], dim=1)
        crops = pool_crops(frames_u8, slots.to(torch.int32).contiguous(), size)
        x = crops.permute(0, 3, 1, 2)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        x = x.to(next(module.parameters()).dtype)
        out = tuple(t.float() for t in module(x))
        return out, valid & ok.reshape(b, k)

    # ---- stage 2: refinement network ---------------------------------------
    (reg2, prob2), valid = run_subnet(model.rnet, boxes, valid, 24)
    counts["stage2_crop_dropped"] = zeros_b   # no size buckets: nothing dropped
    k2 = boxes.shape[1]
    scores = prob2.reshape(b, k2)
    preds = reg2.reshape(b, k2, 4)
    valid = valid & (scores > t2)
    counts["stage2"] = valid.sum(dim=1).to(torch.int32)
    keep = _per_image_nms(boxes, scores, valid, 0.7)
    valid, boxes, scores, preds = _select_topk(
        scores, keep, min(caps.stage3, k2), boxes, scores, preds)
    boxes = square_bbox(refine_bbox(boxes, preds, plus_one=True))

    # ---- stage 3: output network --------------------------------------------
    (reg3, lmk3, prob3), valid = run_subnet(model.onet, boxes, valid, 48)
    counts["stage3_crop_dropped"] = zeros_b
    k3 = boxes.shape[1]
    scores = prob3.reshape(b, k3)
    preds = reg3.reshape(b, k3, 4)
    lmk = lmk3.reshape(b, k3, 10)
    valid = valid & (scores > t3)
    counts["stage3"] = valid.sum(dim=1).to(torch.int32)

    wi = boxes[..., 2] - boxes[..., 0] + 1.0
    hi = boxes[..., 3] - boxes[..., 1] + 1.0
    lm_x = wi[..., None] * lmk[..., :5] + boxes[..., 0:1] - 1.0
    lm_y = hi[..., None] * lmk[..., 5:] + boxes[..., 1:2] - 1.0
    landmarks = torch.stack([lm_x, lm_y], dim=-1)                # [B, k3, 5, 2]

    boxes = refine_bbox(boxes, preds, plus_one=True)
    keep = iom_chain_suppress(boxes, scores, valid, 0.7)
    out_valid, boxes, scores, landmarks = _select_topk(
        scores, keep, min(caps.out, k3), boxes, scores, landmarks)
    return boxes, scores, landmarks, out_valid, counts


