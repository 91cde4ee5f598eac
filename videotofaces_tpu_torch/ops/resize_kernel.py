"""Encoder input prep (K5): the CUDA kernel ``csrc/resize_normalize.cu``,
its plain PyTorch version, and the host packer.

Replaces the JAX package's Pallas kernel ``ops/pallas_resize.py::
resize_normalize_chw_u8``. Contract (both versions):
``resize_normalize(packed_u8 [N, S, S, 3], sizes [N, 2] int32, out_size,
scale, mean, swap_rb=True)`` -> ``[N, 3, out, out]`` float32: image n is the
top-left ``sizes[n] = (h, w)`` corner of its slot (sizes clamped to
[1, S]), resized to out x out with
half-pixel bilinear sampling (cv2 INTER_LINEAR float semantics), channels
swapped BGR -> RGB when ``swap_rb``, then ``(x - mean) * scale``.

Deliberate differences from the JAX kernel: the packed input is HWC (the
crops' own layout, so the host packs without a transpose) where JAX packs
CHW, and the output is NCHW (the port's FaceNet input) where JAX returns
NHWC. The tests permute to compare. The kernel's bound and design are in the
source's header.
"""

import ctypes

import numpy as np
import torch

from . import _cuda

_SRC = "resize_normalize.cu"


def pack_images(images, max_size=256):
    """Host helper: variable-size BGR uint8 images -> (packed
    [N, max_size, max_size, 3] uint8, top-left anchored and zero-padded;
    sizes [N, 2] int32 (h, w)). Images larger than ``max_size`` are
    pre-shrunk with cv2 (rare; encoder inputs are face crops), as the JAX
    package's ``pack_images`` does."""
    import cv2

    n = len(images)
    out = np.zeros((n, max_size, max_size, 3), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    for k, img in enumerate(images):
        h, w = img.shape[:2]
        if max(h, w) > max_size:
            s = max_size / max(h, w)
            img = cv2.resize(img, (max(1, int(w * s)), max(1, int(h * s))))
            h, w = img.shape[:2]
        out[k, :h, :w] = img
        sizes[k] = (h, w)
    return out, sizes


def _check(packed_u8, sizes, out_size):
    if packed_u8.dtype != torch.uint8 or packed_u8.dim() != 4 or packed_u8.shape[-1] != 3 \
            or packed_u8.shape[1] != packed_u8.shape[2]:
        raise ValueError("packed must be uint8 [N, S, S, 3], got %s %s"
                         % (packed_u8.dtype, tuple(packed_u8.shape)))
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (packed_u8.shape[0], 2):
        raise ValueError("sizes must be int32 [N, 2], got %s %s"
                         % (sizes.dtype, tuple(sizes.shape)))
    if out_size < 1:
        raise ValueError("out_size must be positive")


def inv_out(out_size):
    """float32 1 / out_size, the constant XLA multiplies by in place of the
    JAX kernel's division."""
    return float(np.float32(1.0 / out_size))


def hat_weights(true_size, out_size, max_size):
    """[N, out, max] bilinear row-mixing matrices for runtime sizes [N], as
    the jitted JAX kernel's ``_weights`` computes them: XLA turns
    ``(o + 0.5) * h / out - 0.5`` into ``fma((o + 0.5) * h, f32(1/out),
    -0.5)``. The product is exact in float64, so float64 arithmetic with
    one rounding reproduces the fused form bit for bit."""
    dev = true_size.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(max_size, dtype=torch.float32, device=dev)[None, None, :]
    hf = true_size.to(torch.float32)[:, None, None]
    t = ((o + 0.5) * hf).to(torch.float64)
    src = (t * inv_out(out_size) - 0.5).to(torch.float32)
    src = torch.minimum(torch.clamp(src, min=0.0), hf - 1.0)
    w = torch.clamp(1.0 - torch.abs(src - i), min=0.0)
    return torch.where(i < hf, w, torch.zeros_like(w))


def resize_normalize_plain(packed_u8, sizes, out_size, scale, mean, swap_rb=True):
    """Plain PyTorch version: the two hat matrices applied with ``einsum``
    in float32, rows first, then columns."""
    _check(packed_u8, sizes, out_size)
    s = packed_u8.shape[1]
    img = packed_u8.to(torch.float32)
    if swap_rb:
        img = img.flip(-1)
    sizes = sizes.clamp(1, s)
    wy = hat_weights(sizes[:, 0], out_size, s)                   # [N, out, S]
    wx = hat_weights(sizes[:, 1], out_size, s)
    t = torch.einsum("noh,nhwc->nowc", wy, img)                  # [N, out, S, 3]
    r = torch.einsum("nowc,npw->ncop", t, wx)                    # [N, 3, out, out]
    return ((r - mean) * scale).contiguous()


def resize_normalize(packed_u8, sizes, out_size, scale, mean, swap_rb=True):
    """Resize + normalize: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if packed_u8.device.type == "cpu":
        return resize_normalize_plain(packed_u8, sizes, out_size, scale, mean, swap_rb)
    if packed_u8.device.type != "cuda":
        raise ValueError("resize_normalize runs on cuda or cpu, not %s" % packed_u8.device)
    _check(packed_u8, sizes, out_size)
    if sizes.device != packed_u8.device:
        raise ValueError("sizes must be on %s" % packed_u8.device)
    if not (packed_u8.is_contiguous() and sizes.is_contiguous()):
        raise ValueError("packed and sizes must be contiguous")
    n, s = packed_u8.shape[:2]
    out = torch.empty((n, 3, out_size, out_size), dtype=torch.float32,
                      device=packed_u8.device)
    if n == 0:           # nothing to launch, nothing to count
        return out
    lib = _lib()
    with torch.cuda.device(packed_u8.device):   # the C entry point runs on the current device
        rc = lib.resize_normalize_launch(packed_u8.data_ptr(), n, s, sizes.data_ptr(),
                                         out_size, inv_out(out_size), float(scale),
                                         float(mean), int(bool(swap_rb)), out.data_ptr(),
                                         _cuda.stream_ptr(packed_u8.device))
    _cuda.check(rc, "resize_normalize")
    _cuda.count_launch(resize_normalize)
    return out


resize_normalize.launches = 0


def _lib():
    lib = _cuda.load(_SRC)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.resize_normalize_launch.argtypes = [p, i, i, p, i, f, f, f, i, p, p]
        lib.resize_normalize_launch.restype = i
        lib._typed = True
    return lib
