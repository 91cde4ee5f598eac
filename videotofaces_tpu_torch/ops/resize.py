"""Exact adaptive-average pooling of uint8 frames (counterpart of
videotofaces_tpu/ops/resize.py, plain tensor code only).

Inputs are uint8-derived, so window sums are exact integers in int32 (safe
up to ~8.4 MP frames) and every pooled value is one float32 division away
from exact — the ``F.adaptive_avg_pool2d`` contract the MTCNN reference uses
for its image pyramid and its stage-2/3 crops (detectors/mtcnn.py:149-163).

These functions are the plain versions the CUDA kernels are held against
(``ops/pnet_kernel.py`` pools the pyramid levels, ``ops/crops_kernel.py`` the
crops) and the CPU path of the cascade. The JAX package's phase-split, s2d
and matmul pool variants are TPU layouts and have no counterpart here.

Also here: the Faster R-CNN preprocess resize, ``bilinear_resize_matmul``,
two interpolation-matrix products (XLA computes them in the JAX package; no
Pallas kernel is involved).
"""

import functools

import numpy as np
import torch

from ..utils.profiling import sync_span


def pool_bounds_1d(n_in, n_out):
    """Static adaptive-pool window boundaries along one axis: window i covers
    [floor(i*n_in/n_out), ceil((i+1)*n_in/n_out)). Returns (starts, ends)
    int64 numpy arrays of length ``n_out``."""
    i = np.arange(n_out, dtype=np.int64)
    starts = (i * n_in) // n_out
    ends = -((-((i + 1) * n_in)) // n_out)
    return starts, ends


@functools.lru_cache(maxsize=None)
def pool_windows_le2(out_hw, true_hw):
    """True when every adaptive-pool window of (true_hw -> out_hw) is at most
    2 wide on both axes (always so for upscaled pyramid levels). Cached: the
    PNet wrapper asks once per level per forward."""
    h, w = true_hw
    oh, ow = out_hw

    def wmax(n_in, n_out):
        s, e = pool_bounds_1d(n_in, n_out)
        return int((e - s).max())

    return wmax(h, oh) <= 2 and wmax(w, ow) <= 2


def integral_image(frames, dtype=torch.int32):
    """Zero-padded 2D inclusive prefix sum: [B, H, W, C] -> [B, H+1, W+1, C]."""
    s = torch.cumsum(torch.cumsum(frames.to(dtype), dim=-3), dim=-2).to(dtype)
    return torch.nn.functional.pad(s, (0, 0, 1, 0, 1, 0))


def adaptive_pool_full(ii, out_hw, true_hw):
    """Full-frame adaptive average pool with static boundaries, as 4 gathers
    from the integral image. ii: [B, H+1, W+1, C]; returns [B, oh, ow, C]
    float32."""
    h, w = true_hw
    oh, ow = out_hw
    ys, ye = pool_bounds_1d(h, oh)
    xs, xe = pool_bounds_1d(w, ow)
    dev = ii.device
    t = lambda a: torch.as_tensor(a, device=dev)
    rows = ii.index_select(-3, t(ye)) - ii.index_select(-3, t(ys))
    sums = rows.index_select(-2, t(xe)) - rows.index_select(-2, t(xs))
    area = torch.as_tensor((ye - ys)[:, None] * (xe - xs)[None, :],
                           dtype=torch.float32, device=dev)
    return sums.to(torch.float32) / area[..., None]


def adaptive_pool_boxes_batched(ii, boxes_xyxy, imgidx, out_size):
    """Adaptive-average-pool dynamic integer windows of a batch of integral
    images. ii: [B, H+1, W+1, C]; boxes_xyxy: [N, 4] int32 windows
    [x1:x2, y1:y2); imgidx: [N] int32. Returns [N, oh, ow, C] float32 —
    exactly ``F.adaptive_avg_pool2d(crop, out_size)`` per window."""
    b, hh, ww_, c = ii.shape
    flat = ii.reshape(b * hh * ww_, c)
    oh, ow = out_size
    boxes = boxes_xyxy.to(torch.int64)
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    h = (y2 - y1)[:, None]
    w = (x2 - x1)[:, None]
    dev = ii.device
    iy = torch.arange(oh + 1, dtype=torch.int64, device=dev)[None, :]
    ix = torch.arange(ow + 1, dtype=torch.int64, device=dev)[None, :]

    def bounds(c0, size, n, grid):
        starts = c0[:, None] + torch.div(grid[:, :n] * size, n, rounding_mode="floor")
        ends = c0[:, None] - torch.div(-(grid[:, 1:] * size), n, rounding_mode="floor")
        return starts, ends

    y_start, y_end = bounds(y1, h, oh, iy)
    x_start, x_end = bounds(x1, w, ow, ix)
    base = (imgidx.to(torch.int64) * hh * ww_)[:, None, None]

    def corner(yy, xx):
        idx = base + yy[:, :, None] * ww_ + xx[:, None, :]
        return flat[idx.reshape(-1)].reshape(idx.shape + (c,))

    total = (corner(y_end, x_end) - corner(y_start, x_end)
             - corner(y_end, x_start) + corner(y_start, x_start)).to(torch.float32)
    area = ((y_end - y_start)[:, :, None]
            * (x_end - x_start)[:, None, :]).to(torch.float32)
    return total / torch.clamp(area, min=1.0)[..., None]


def normalize(avg):
    """MTCNN input normalization of window averages: (x - 127.5) / 128."""
    return (avg - 127.5) / 128.0


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(in_size: int, out_size: int):
    """[out, in] half-pixel bilinear interpolation matrix (cv2 INTER_LINEAR /
    torch align_corners=False semantics, edge-clamped), float32 numpy."""
    src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1.0)
    i = np.arange(in_size)[None, :]
    w = np.maximum(0.0, 1.0 - np.abs(src[:, None] - i))
    return w.astype(np.float32)


def bilinear_resize_matmul(x, out_hw, canvas_hw=None):
    """Half-pixel bilinear resize of [..., H, W, C] as two matrix products,
    float32 out. ``canvas_hw`` (>= out_hw) zero-pads the interpolation
    matrices, so the result lands on a [canvas_h, canvas_w] zero canvas (the
    detector's pad to a multiple of 32 comes out of the second product).
    The products follow the precision policy (TF32 allowed outside
    "highest")."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    wh = _bilinear_matrix(h, oh)
    ww = _bilinear_matrix(w, ow)
    if canvas_hw is not None:
        ch, cw = canvas_hw
        wh = np.pad(wh, ((0, ch - oh), (0, 0)))
        ww = np.pad(ww, ((0, cw - ow), (0, 0)))
    with sync_span(x.device):
        wh = torch.from_numpy(wh).to(x.device)
    with sync_span(x.device):
        ww = torch.from_numpy(ww).to(x.device)
    x = x.to(torch.float32)
    x = torch.einsum("oh,...hwc->...owc", wh, x)
    return torch.einsum("pw,...owc->...opc", ww, x)
