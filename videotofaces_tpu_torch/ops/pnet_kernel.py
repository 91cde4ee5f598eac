"""PNet over one pyramid level, pool included: the CUDA kernel
``csrc/pnet_level.cu`` and its plain PyTorch version.

Replaces the JAX package's Pallas kernels ``ops/pallas_pnet.py::
pnet_level_fused`` (upscaled levels, pool windows <= 2 wide) and
``::pnet_level`` (downscaled levels, pooled beforehand): one wrapper takes
the uint8 BGR frames and pools every level with exact int32 window sums,
which is bit-identical to both JAX pools.

Contract (both versions): ``pnet_level(frames_u8 [B, H, W, 3], (SH, SW),
weights, dtype)`` -> ``reg [B, 4, PH, PW]`` in ``dtype`` and ``prob
[B, PH, PW]`` float32, PH = ceil((SH-2)/2) - 4, PW = ceil((SW-2)/2) - 4.
On the card, levels whose pool windows are at most 2 wide (the upscaled
ones) are pooled inside the PNet kernel, the others by a pre-pool kernel
into a small scratch level first — the same split as the two JAX kernels,
and faster on the upscaled levels than pre-pooling every level.
``dtype`` is the compute dtype (float32 or bfloat16): conv operands are
``dtype``-valued, products and sums float32, and the pooled level, pool1,
conv2, conv3 and reg are rounded to ``dtype`` where the JAX kernel rounds
them. ``weights`` is ``pack_weights(pnet, dtype)``.

The kernel's bound and design are in the source's header.
"""

import ctypes

import torch
import torch.nn.functional as F

from .. import config
from . import _cuda
from .resize import adaptive_pool_full, integral_image, normalize, pool_windows_le2

_SRC = "pnet_level.cu"
NWEIGHTS = 6632   # must equal pnet_weight_count() of the source

# (name, torch shape) in packed order; conv kernels HWIO, heads [32, 6]
_LAYOUT = (("w1", (3, 3, 3, 10)), ("b1", (10,)), ("a1", (10,)),
           ("w2", (3, 3, 10, 16)), ("b2", (16,)), ("a2", (16,)),
           ("w3", (3, 3, 16, 32)), ("b3", (32,)), ("a3", (32,)),
           ("wh", (32, 6)), ("bh", (6,)))


def pack_weights(pnet, dtype):
    """PNet module -> the kernel's float32 weight vector [NWEIGHTS]. Conv and
    head weights are rounded to ``dtype`` (they are conv operands); biases
    and PReLU slopes stay float32, as the JAX kernel's packing keeps them."""
    rnd = lambda t: t.detach().to(dtype).float()
    hwio = lambda conv: rnd(conv.weight).permute(2, 3, 1, 0)
    heads = torch.cat([rnd(pnet.reg.weight)[:, :, 0, 0],
                       rnd(pnet.cls.weight)[:, :, 0, 0]]).t()       # [32, 6]
    parts = []
    for unit in (pnet.conv1, pnet.conv2, pnet.conv3):
        parts += [hwio(unit.conv), unit.conv.bias.detach().float(),
                  unit.prelu.alpha.detach().float()]
    parts += [heads, torch.cat([pnet.reg.bias, pnet.cls.bias]).detach().float()]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _unpack(weights):
    out, o = {}, 0
    for name, shape in _LAYOUT:
        n = 1
        for s in shape:
            n *= s
        out[name] = weights[o:o + n].reshape(shape)
        o += n
    return out


def out_hw(level_hw):
    sh, sw = level_hw
    return (sh - 1) // 2 - 4, (sw - 1) // 2 - 4


def _check_level(frames_u8, level_hw):
    ph, pw = out_hw(level_hw)
    if ph < 1 or pw < 1:
        raise ValueError("pyramid level %r is too small for PNet" % (level_hw,))
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError("frames must be uint8 [B, H, W, 3], got %s %s"
                         % (frames_u8.dtype, tuple(frames_u8.shape)))
    return ph, pw


def pnet_level_plain(frames_u8, level_hw, weights, dtype):
    """Plain PyTorch version: integral-image pool, then float32 convolutions
    on ``dtype``-rounded operands, rounding where the kernel rounds."""
    _check_level(frames_u8, level_hw)
    h, w = frames_u8.shape[1:3]
    p = _unpack(weights.float())
    rnd = lambda t: t.to(dtype).float()
    prelu = lambda v, a: torch.clamp(v, min=0) + a[:, None, None] * torch.clamp(v, max=0)
    conv = lambda x, k, bias: F.conv2d(x, k.permute(3, 2, 0, 1)) + bias[:, None, None]

    ii = integral_image(frames_u8.flip(-1))                  # RGB
    lvl = normalize(adaptive_pool_full(ii, level_hw, (h, w)))
    x = rnd(lvl.permute(0, 3, 1, 2))
    with config.precision_scope("highest"):   # no TF32 on the card
        y = prelu(conv(x, p["w1"], p["b1"]), p["a1"])
        y = rnd(F.max_pool2d(y, 2, 2, ceil_mode=True))
        y = rnd(prelu(conv(y, p["w2"], p["b2"]), p["a2"]))
        y = rnd(prelu(conv(y, p["w3"], p["b3"]), p["a3"]))
        hv = torch.einsum("bcyx,co->boyx", y, p["wh"]) + p["bh"][:, None, None]
    return hv[:, :4].to(dtype), torch.sigmoid(hv[:, 5] - hv[:, 4])


def pnet_level(frames_u8, level_hw, weights, dtype):
    """PNet over one level: the CUDA kernel for frames on the card, the plain
    version for frames on the CPU."""
    if frames_u8.device.type == "cpu":
        return pnet_level_plain(frames_u8, level_hw, weights, dtype)
    if frames_u8.device.type != "cuda":
        raise ValueError("pnet_level runs on cuda or cpu, not %s" % frames_u8.device)
    ph, pw = _check_level(frames_u8, level_hw)
    if not frames_u8.is_contiguous():
        raise ValueError("frames must be contiguous")
    if (weights.device != frames_u8.device or weights.dtype != torch.float32
            or weights.shape != (NWEIGHTS,) or not weights.is_contiguous()):
        raise ValueError("weights must be a contiguous float32 [%d] tensor on %s"
                         % (NWEIGHTS, frames_u8.device))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s" % dtype)
    lib = _lib()
    b, h, w = frames_u8.shape[:3]
    sh, sw = level_hw
    dev = frames_u8.device
    reg = torch.empty((b, 4, ph, pw), dtype=dtype, device=dev)
    prob = torch.empty((b, ph, pw), dtype=torch.float32, device=dev)
    # levels with windows wider than 2 are pre-pooled into this scratch
    pooled = (None if pool_windows_le2(level_hw, (h, w))
              else torch.empty((b, 3, sh, sw), dtype=dtype, device=dev))
    rc = lib.pnet_level_launch(
        frames_u8.data_ptr(), b, h, w, sh, sw,
        None if pooled is None else pooled.data_ptr(), weights.data_ptr(),
        reg.data_ptr(), prob.data_ptr(), int(dtype == torch.bfloat16),
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "pnet_level")
    pnet_level.launches += 1
    return reg, prob


pnet_level.launches = 0


def _lib():
    lib = _cuda.load(_SRC)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pnet_level_launch.argtypes = [p, i, i, i, i, i, p, p, p, p, i, p]
        lib.pnet_level_launch.restype = i
        lib.pnet_weight_count.restype = i
        if lib.pnet_weight_count() != NWEIGHTS:
            raise RuntimeError("pnet_level.cu packs %d weights, the wrapper %d"
                               % (lib.pnet_weight_count(), NWEIGHTS))
        lib._typed = True
    return lib
