"""Frozen copy of the port's ops/roi_align.py (the plain version of K4) for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import numpy as np
import torch

STRIDES = (4, 8, 16, 32)
OUT_SIZE = 7
K_MAX = 8
# the least float32 sqrt(w * h) that jitted JAX puts on P3, P4 and P5: one
# ulp below 112 and 224, two ulps below 448
LEVEL_EDGES = (111.99999237060547, 223.99998474121094, 447.99993896484375)


def inv_out(out_size=OUT_SIZE):
    """float32 1 / out_size, the constant XLA multiplies by in place of the
    JAX package's division by ``out_size``."""
    return float(np.float32(1.0 / out_size))


def assign_fpn_levels(boxes, num_levels=4, canonical=224.0, base_level=2):
    """FPN level index in [0, num_levels) of boxes [..., 4] (x1, y1, x2,
    y2), as int64: the number of level edges that sqrt(w * h) reaches.
    Other ``canonical`` / ``base_level`` than the detector's take
    floor(4 + log2(s / canonical)), clamped, in float32 (XLA's log2 may
    round the other way within an ulp of an edge)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    s = torch.sqrt(ws * hs)
    if (canonical, base_level) != (224.0, 2):
        k = torch.floor(4.0 + torch.log2(torch.clamp(s, min=1e-6) / canonical))
        k = torch.clamp(k, base_level, base_level + num_levels - 1)
        return (k - base_level).to(torch.int64)
    lv = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
    for edge in LEVEL_EDGES[:num_levels - 1]:
        lv += (s >= edge).to(torch.int64)
    return lv


def samples_per_bin(c1, c2, out_size=OUT_SIZE):
    """Adaptive sample count k = ceil(max(c2 - c1, 0) / out_size) as jitted
    JAX computes it (a product with the float32 reciprocal), int32."""
    return torch.ceil(torch.clamp(c2 - c1, min=0.0) * inv_out(out_size)).to(torch.int32)


def _axis_weights(c1, c2, true_size, k, window_start, window, out_size=OUT_SIZE,
                  k_max=K_MAX):
    """Per-roi 1D pooling weights along one axis, [R, out_size, window]
    float32: for bin i, the average over the bin's first min(k, k_max)
    samples of the bilinear hat function at the sample, on rows
    ``window_start + [0, window)``.

    c1 / c2: [R] roi start / end in feature coordinates (box * scale - 0.5);
    true_size: the level's extent (python int); k: [R] samples per bin. A
    sample outside [-1, true_size] contributes zero, one in the last row
    clamps to it (torchvision's rules). Rois that need k > k_max use their
    first k_max samples and divide by k_max. Every operation is one float32
    rounding in the order the jitted JAX function rounds, so the weights
    equal it bit for bit."""
    roi = c2 - c1
    bin_size = roi * inv_out(out_size)
    kf = torch.clamp(k.to(torch.float32), min=1.0)
    step = bin_size / kf
    dev = c1.device
    r = torch.arange(window, dtype=torch.float32, device=dev)[None, None, :]
    abs_r = window_start.to(torch.float32)[:, None, None] + r
    # sample coordinate y = c1 + i * bin + (j + 0.5) * step, which XLA
    # compiles as fma(i, bin, c1) + round((j + 0.5) * step): a float32
    # product is exact in float64, so the float64 sum rounded once to
    # float32 is the fused result (the kernel calls fmaf)
    i = torch.arange(out_size, dtype=torch.float64, device=dev)[None, :]
    row = (c1.double()[:, None] + i * bin_size.double()[:, None]).float()
    acc = None
    for j in range(k_max):
        y = row + (j + 0.5) * step[:, None]                              # [R, out]
        ok = (j < k)[:, None] & (y >= -1.0) & (y <= true_size)
        y = torch.clamp(y, min=0.0)
        y_low = torch.floor(y)
        at_edge = y_low >= true_size - 1
        y_low = torch.where(at_edge, torch.full_like(y_low, float(true_size - 1)), y_low)
        frac = torch.where(at_edge, torch.zeros_like(y), y - y_low)
        w_low = torch.where(abs_r == y_low[..., None], (1.0 - frac)[..., None], 0.0)
        w_high = torch.where(abs_r == (y_low + 1.0)[..., None], frac[..., None], 0.0)
        w = (w_low + w_high) * ok[..., None].to(torch.float32)
        acc = w if acc is None else acc + w
    denom = torch.clamp(kf, max=float(k_max))
    return acc / denom[:, None, None]


def roi_coords(boxes, stride):
    """(x1, y1, x2, y2) feature coordinates of boxes [..., 4] on a level of
    ``stride``: box / stride - 0.5 (``aligned=True``)."""
    scale = 1.0 / stride
    return tuple(boxes[..., i] * scale - 0.5 for i in range(4))


def _check(fmaps, boxes, valid, strides):
    if len(fmaps) != len(strides):
        raise ValueError("one stride per feature map: %d maps, %d strides"
                         % (len(fmaps), len(strides)))
    b, c = fmaps[0].shape[0], fmaps[0].shape[-1]
    for f in fmaps:
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c or f.dtype != fmaps[0].dtype:
            raise ValueError("feature maps must be [B, H, W, C] of one dtype, B and C; "
                             "got %s" % [(tuple(t.shape), t.dtype) for t in fmaps])
    if boxes.dim() != 3 or boxes.shape[0] != b or boxes.shape[2] != 4 \
            or boxes.dtype != torch.float32:
        raise ValueError("boxes must be float32 [B, R, 4], got %s %s"
                         % (boxes.dtype, tuple(boxes.shape)))
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError("valid must be bool [B, R], got %s %s"
                         % (valid.dtype, tuple(valid.shape)))


def roi_align_fpn_plain(fmaps, boxes, valid, strides=STRIDES, out_size=OUT_SIZE,
                        chunk=8, levels=None):
    """Plain PyTorch version: the dense separable method in float32.

    fmaps: list of [B, H_l, W_l, C] (NHWC, float32 or bfloat16 — read as
    float32); boxes [B, R, 4] float32 in input pixels; valid [B, R] bool.
    Returns [B, R, out, out, C] float32, zero for slots that are not valid.
    Each level pools only its own rois, ``chunk`` rois per pair of
    products ([chunk, out, W, C] is the largest intermediate)."""
    _check(fmaps, boxes, valid, strides)
    b, r = boxes.shape[:2]
    c = fmaps[0].shape[-1]
    if levels is None:
        levels = assign_fpn_levels(boxes, len(fmaps))
    out = torch.zeros((b, r, out_size, out_size, c), dtype=torch.float32,
                      device=boxes.device)
    for lv, (fmap, stride) in enumerate(zip(fmaps, strides)):
        h, w = fmap.shape[1], fmap.shape[2]
        for img in range(b):
            idx = torch.nonzero(valid[img] & (levels[img] == lv)).flatten()
            if idx.numel() == 0:
                continue
            x1, y1, x2, y2 = roi_coords(boxes[img, idx], stride)
            zeros = torch.zeros_like(idx)
            wy = _axis_weights(y1, y2, h, samples_per_bin(y1, y2, out_size), zeros, h,
                               out_size)                                   # [n, out, H]
            wx = _axis_weights(x1, x2, w, samples_per_bin(x1, x2, out_size), zeros, w,
                               out_size)                                   # [n, out, W]
            f = fmap[img].to(torch.float32)
            for s in range(0, idx.numel(), chunk):
                t = torch.einsum("rbh,hwc->rbwc", wy[s:s + chunk], f)
                out[img, idx[s:s + chunk]] = torch.einsum("rdw,rbwc->rbdc",
                                                          wx[s:s + chunk], t)
    return out



def roi_align_fpn(fmaps, boxes, valid, strides=STRIDES):
    """The plain multilevel RoIAlign: (pooled [B, R, 7, 7, C], dropped,
    kept, truncated), nothing dropped or truncated."""
    levels = assign_fpn_levels(boxes, len(fmaps))
    pooled = roi_align_fpn_plain(fmaps, boxes, valid, strides, levels=levels)
    zeros = torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)
    return pooled, zeros, valid.clone(), zeros.clone()
