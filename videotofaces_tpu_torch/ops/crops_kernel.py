"""MTCNN stage-2/3 crop resample: the CUDA kernel ``csrc/pool_crops.cu`` and
its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/pallas_crops.py::
adaptive_pool_crops``. Contract (both versions): ``pool_crops(frames_u8
[B, H, W, 3], slots [N, 6] int32, out_size)`` -> ``[N, out, out, 3]``
float32, where slot row (img, y0, x0, win_h, win_w, ok) asks for the exact
``F.adaptive_avg_pool2d`` of frame window [y0, y0+win_h) x [x0, x0+win_w)
(RGB), normalized as (x - 127.5) / 128. Slots with ok == 0, or whose window
is not inside the frame, come out zero. Window sums are exact int32, so both
versions equal the JAX gather engine bit for bit; no window size is too
large, so no candidate is ever dropped.

The kernel's bound and design are in the source's header.
"""

import ctypes

import torch

from . import _cuda
from .resize import adaptive_pool_boxes_batched, integral_image, normalize

_SRC = "pool_crops.cu"


def _check(frames_u8, slots):
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError("frames must be uint8 [B, H, W, 3], got %s %s"
                         % (frames_u8.dtype, tuple(frames_u8.shape)))
    if slots.dtype != torch.int32 or slots.dim() != 2 or slots.shape[1] != 6:
        raise ValueError("slots must be int32 [N, 6], got %s %s"
                         % (slots.dtype, tuple(slots.shape)))


def live_slots(slots, frame_bhw):
    """[N] bool: ok != 0 and the window lies inside the frame."""
    b, h, w = frame_bhw
    img, y0, x0, wh, ww, ok = slots.unbind(1)
    return ((ok != 0) & (img >= 0) & (img < b) & (y0 >= 0) & (x0 >= 0)
            & (wh > 0) & (ww > 0) & (y0 <= h - wh) & (x0 <= w - ww))


def pool_crops_plain(frames_u8, slots, out_size):
    """Plain PyTorch version: integral-image corner gathers per slot."""
    _check(frames_u8, slots)
    live = live_slots(slots, frames_u8.shape[:3])
    img, y0, x0, wh, ww, _ = slots.unbind(1)
    win = torch.stack([x0, y0, x0 + ww, y0 + wh], dim=1)
    unit = torch.tensor([0, 0, 1, 1], dtype=win.dtype, device=win.device)
    win = torch.where(live[:, None], win, unit)
    imgidx = torch.where(live, img, torch.zeros_like(img))
    ii = integral_image(frames_u8.flip(-1))                  # RGB
    crops = normalize(adaptive_pool_boxes_batched(ii, win, imgidx,
                                                  (out_size, out_size)))
    return torch.where(live[:, None, None, None], crops, torch.zeros_like(crops))


def pool_crops(frames_u8, slots, out_size):
    """Crop resample: the CUDA kernel for frames on the card, the plain
    version for frames on the CPU."""
    if frames_u8.device.type == "cpu":
        return pool_crops_plain(frames_u8, slots, out_size)
    if frames_u8.device.type != "cuda":
        raise ValueError("pool_crops runs on cuda or cpu, not %s" % frames_u8.device)
    _check(frames_u8, slots)
    if slots.device != frames_u8.device:
        raise ValueError("slots must be on %s" % frames_u8.device)
    if not (frames_u8.is_contiguous() and slots.is_contiguous()):
        raise ValueError("frames and slots must be contiguous")
    if out_size < 1:
        raise ValueError("out_size must be positive")
    lib = _lib()
    b, h, w = frames_u8.shape[:3]
    n = slots.shape[0]
    out = torch.empty((n, out_size, out_size, 3), dtype=torch.float32,
                      device=frames_u8.device)
    if n == 0:           # nothing to launch, nothing to count
        return out
    with torch.cuda.device(frames_u8.device):   # the C entry point runs on the current device
        rc = lib.pool_crops_launch(frames_u8.data_ptr(), b, h, w, slots.data_ptr(),
                                   n, out_size, out.data_ptr(),
                                   _cuda.stream_ptr(frames_u8.device))
    _cuda.check(rc, "pool_crops")
    _cuda.count_launch(pool_crops)
    return out


pool_crops.launches = 0


def _lib():
    lib = _cuda.load(_SRC)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pool_crops_launch.argtypes = [p, i, i, i, p, i, i, p, p]
        lib.pool_crops_launch.restype = i
        lib._typed = True
    return lib
