"""MTCNN 3-stage cascade face detector (counterpart of
videotofaces_tpu/models/mtcnn.py).

Architecture parity target: detectors/mtcnn.py of the reference (PNet / RNet
/ ONet in the facenet-pytorch weights layout; pipeline semantics at
mtcnn.py:133-252). As in the JAX package, every filter and NMS point keeps a
fixed-capacity buffer plus a validity mask, capacities come from ``Caps``,
and the true candidate counts come back so the host can detect overflow.

The frames' device decides the engine: frames on the card run every pyramid
level through the hand-written kernel ``ops/pnet_kernel.py`` (pool + whole
PNet) and the stage-2/3 crops through ``ops/crops_kernel.py``; frames on the
CPU run the plain versions of the same two functions. RNet and ONet are
``nn.Module``s (cuDNN convolutions on the card).

Deliberate differences from the JAX ``full_forward``:

- stage-1 selection is an exact stable top-k in every precision mode, so
  ``counts["stage1_select_overflow"]`` is always 0 (the JAX throughput mode
  selects per lane block and can lose candidates);
- the crop kernel has no size buckets, so ``counts["stage{2,3}_crop_dropped"]``
  are always 0;
- the TPU engine knobs (``crop_engine``, ``pnet_stem``, ``pnet_tail``,
  ``stage1_pick``, ``pallas_pool``, ``pnet_impl``) do not exist.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.crops_kernel import pool_crops
from ..ops.nms import iom_chain_suppress, nms_keep_mask_bucketed, take_rows, topk_by_score
from ..ops.pnet_kernel import packed_weights, pnet_level
from ..utils.profiling import span, sync_span
from ..utils.weights import mtcnn_from_jax
from .layers import PConv, PReLU, init_uniform_fan_in_


def _flatten_whc(x):
    """torch's permute(0, 3, 2, 1) + flatten of an NCHW map: (w, h, c) order
    (reference mtcnn.py:68), so the JAX Dense weights carry over as they are."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Fully-convolutional proposal net: 12x12 receptive field, stride 2.
    The cascade runs it through ``ops/pnet_kernel.pnet_level``; ``forward``
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

    @classmethod
    def from_jax(cls, params_np):
        """Build from the JAX package's parameter tree (numpy arrays)."""
        model = cls()
        for name, sd in mtcnn_from_jax(params_np).items():
            getattr(model, name).load_state_dict(sd, strict=True)
        return model

    @classmethod
    def seeded(cls, seed=0):
        """Random weights from an explicit ``torch.Generator``: conv/dense
        weights and biases uniform in +-1/sqrt(fan_in) (torch's default
        ranges), PReLU slopes 0.25."""
        return init_uniform_fan_in_(cls(), seed)


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
    weights = packed_weights(model.pnet, kdt, dev)   # packed once per model
    zeros_b = torch.zeros((b,), dtype=torch.int32, device=dev)
    counts = {}

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

    # ---- stage 1: proposal network over the pyramid -------------------------
    with span("mtcnn:stage1"):
        s_boxes, s_scores, s_preds, s_valid = [], [], [], []
        total_cand, scale_max = zeros_b, zeros_b
        for sc, level_hw in zip(scales, sizes):
            reg_m, prob_m = pnet_level(frames_u8, level_hw, weights, kdt)
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
            with sync_span(dev):
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

    # ---- stage 2: cross-scale NMS, refinement network -----------------------
    with span("mtcnn:stage2"):
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
    with span("mtcnn:stage3"):
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


def torch_spec():
    """Checkpoint spec in the reference registration order (mtcnn.py:12-130):
    PNet (conv1..3 + PReLUs, cls, reg), RNet (+dense4/prelu4, cls, reg),
    ONet (+dense5/prelu5, cls, reg, landmarks). The paths are the JAX
    layout's, which ``MTCNN.from_jax`` reads."""
    from ..utils import weights as W

    def pconv(path):
        return [W.conv(f"{path}/conv", bias=True), W.param(f"{path}/prelu/alpha")]

    els = []
    for c in ("conv1", "conv2", "conv3"):
        els += pconv(f"pnet/{c}")
    els += [W.conv("pnet/cls", bias=True), W.conv("pnet/reg", bias=True)]
    for c in ("conv1", "conv2", "conv3"):
        els += pconv(f"rnet/{c}")
    els += [W.linear("rnet/dense4"), W.param("rnet/prelu4/alpha"),
            W.linear("rnet/cls"), W.linear("rnet/reg")]
    for c in ("conv1", "conv2", "conv3", "conv4"):
        els += pconv(f"onet/{c}")
    els += [W.linear("onet/dense5"), W.param("onet/prelu5/alpha"),
            W.linear("onet/cls"), W.linear("onet/reg"), W.linear("onet/lmk")]
    return els
