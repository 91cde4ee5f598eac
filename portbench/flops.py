"""The yardstick's arithmetic: the chip's peaks, a kernel's least time
(the larger of its operations over the peak and its bytes over the
memory bandwidth), the work of K1/K2 (``pnet_level``), K3 (``pool_crops``)
and K4 (``roi_align``) from this run's shapes, and the model FLOPs of a
forward pass (2 x multiply-adds of its convolutions and dense layers,
counted by forward hooks). Frozen from the port's ``chip_smoke.py``
(``PEAK_OPS``, ``HBM_BYTES_PER_S``, ``bound_ms``, ``pnet_work``,
``crops_work``, ``roi_work``, ``roi_axis_samples``, ``forward_ops``); the
union of touched pixels is taken with a difference array instead of a
loop over windows, which counts the same pixels."""

import numpy as np
import torch

from .reference import roi_align as RA
from .reference.resize import pool_bounds_1d

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor-core rate
            "tf32": 495e12,        # dense TF32 tensor-core rate
            "float32": 67e12}      # float32 on the CUDA cores
PNET_PLAIN_WEIGHTS = 6632          # the PNet kernel's float32 weight vector


def bound_s(nbytes, ops, dtype):
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def peak(precision):
    """The peak FLOP/s of a configuration's precision."""
    return PEAK_OPS[{"highest": "float32", "high": "tf32", "default": "tf32",
                     "bfloat16": "bfloat16"}[precision]]


def pnet_work(level_hw, b, h, w, dtype="float32"):
    """(bytes, operations) of one level's pool + PNet over b frames: frames
    read once, reg / prob written once; pool adds plus 2 ops per
    multiply-add."""
    sh, sw = level_hw
    ch, cw = sh - 2, sw - 2
    qh, qw = (ch + 1) // 2, (cw + 1) // 2
    ph, pw = qh - 4, qw - 4
    ys, ye = pool_bounds_1d(h, sh)
    xs, xe = pool_bounds_1d(w, sw)
    pool = int((ye - ys).sum()) * int((xe - xs).sum()) * 3
    macs = ch * cw * 10 * 27 + (qh - 2) * (qw - 2) * 16 * 90 + ph * pw * (32 * 144 + 6 * 32)
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = b * h * w * 3 + PNET_PLAIN_WEIGHTS * 4 + b * ph * pw * (4 * esize + 4)
    return nbytes, b * (pool + 2 * macs)


def covered(b, h, w, img, y0, y1, x0, x1):
    """Pixels of [b, h, w] inside the union of the rectangles
    [y0, y1) x [x0, x1) of image ``img`` (integer arrays, clipped)."""
    y0, y1 = np.clip(y0, 0, h), np.clip(y1, 0, h)
    x0, x1 = np.clip(x0, 0, w), np.clip(x1, 0, w)
    ok = (y1 > y0) & (x1 > x0)
    img, y0, y1, x0, x1 = img[ok], y0[ok], y1[ok], x0[ok], x1[ok]
    diff = np.zeros((b, h + 1, w + 1), np.int32)
    np.add.at(diff, (img, y0, x0), 1)
    np.add.at(diff, (img, y0, x1), -1)
    np.add.at(diff, (img, y1, x0), -1)
    np.add.at(diff, (img, y1, x1), 1)
    return int((diff.cumsum(1).cumsum(2)[:, :h, :w] > 0).sum())


def crops_work(slots, out_size, b, h, w):
    """(bytes, operations) of K3 over one slot table [N, 6] (img, y0, x0,
    h, w, ok): the union of the live windows' frame bytes read once, the
    crops written once, the table read once; one add per window byte plus
    a division and normalization per output."""
    slots = np.asarray(slots, np.int64)
    live = slots[:, 5] != 0
    img, y0, x0, wh, ww = (slots[live, i] for i in range(5))
    adds = int((wh * ww).sum()) * 3
    nbytes = covered(b, h, w, img, y0, y0 + wh, x0, x0 + ww) * 3 \
        + slots.shape[0] * (out_size * out_size * 3 * 4 + 24)
    return nbytes, adds + slots.shape[0] * out_size * out_size * 3 * 3


def roi_axis_samples(c1, c2, size):
    """[n] samples of n rois along one axis that lie inside [-1, size] over
    the 7 bins (k and the coordinates in float32, as the RoIAlign computes
    them)."""
    k = RA.samples_per_bin(c1, c2)
    bin_size = (c2 - c1) * RA.inv_out()
    step = bin_size / torch.clamp(k.to(torch.float32), min=1.0)
    i = torch.arange(RA.OUT_SIZE, dtype=torch.float64)
    row = (c1.double()[:, None] + i * bin_size.double()[:, None]).float()
    j = torch.arange(RA.K_MAX)
    y = row[:, :, None] + (j + 0.5).float() * step[:, None, None]
    ok = (j < k[:, None, None]) & (y >= -1.0) & (y <= size)
    return ok.sum((1, 2))


def roi_work(boxes, valid, fmap_hw, c, esize):
    """(bytes, operations) of K4 on one batch's rois (boxes [B, R, 4],
    valid [B, R], host tensors): the level pixels that valid rois touch
    (each roi's feature rectangle plus the bilinear halo, their union per
    image and level) read once, the pooled float32 output, boxes, levels
    and flags; per sample inside the level and per channel, 4 taps x a
    multiply-add, plus one scale per output."""
    boxes, valid = boxes.float(), valid.bool()
    lv = RA.assign_fpn_levels(boxes)
    b, r = valid.shape
    touched = samples = 0
    for level, (h, w) in enumerate(fmap_hw):
        sel = valid & (lv == level)
        if not bool(sel.any()):
            continue
        img = torch.nonzero(sel)[:, 0].numpy()
        x1, y1, x2, y2 = RA.roi_coords(boxes[sel], RA.STRIDES[level])
        samples += int((roi_axis_samples(y1, y2, h) * roi_axis_samples(x1, x2, w)).sum())
        ys0 = np.maximum(np.floor(y1.numpy()).astype(np.int64), 0)
        ys1 = np.maximum(np.minimum(np.ceil(y2.numpy()).astype(np.int64) + 2, h), 0)
        xs0 = np.maximum(np.floor(x1.numpy()).astype(np.int64), 0)
        xs1 = np.maximum(np.minimum(np.ceil(x2.numpy()).astype(np.int64) + 2, w), 0)
        touched += covered(b, h, w, img, ys0, ys1, xs0, xs1)
    nbytes = touched * c * esize + b * r * (49 * c * 4 + 16 + 4 + 1)
    return nbytes, samples * c * 8 + b * r * 49 * c


def forward_ops(model, run, kinds=(torch.nn.Conv2d, torch.nn.Linear)):
    """2 x multiply-adds of the ``kinds`` layers of ``model`` in ``run()``
    (a forward through it)."""
    total = [0]

    def count(mod, i, o):
        total[0] += 2 * o.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            run()
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]
