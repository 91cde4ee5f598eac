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
and faster on the upscaled levels than pre-pooling every level. bfloat16
runs the convolutions on the tensor cores, float32 (the parity mode) on the
CUDA cores.
``dtype`` is the compute dtype (float32 or bfloat16): conv operands are
``dtype``-valued, products and sums float32, and the pooled level, pool1,
conv2, conv3 and reg are rounded to ``dtype`` where the JAX kernel rounds
them. ``weights`` is ``pack_weights(pnet, dtype)``: the plain weights, and
for bfloat16 the same weights again as the tensor-core kernel's B fragments
(``tc_fragments``); ``packed_weights`` caches it per module, dtype and
device.

The kernel's bound and design are in the source's header.
"""

import ctypes

import torch
import torch.nn.functional as F

from .. import config
from . import _cuda
from .resize import adaptive_pool_full, integral_image, normalize, pool_windows_le2

_SRC = "pnet_level.cu"
NPLAIN = 6632     # plain weights; must equal pnet_plain_weight_count()
# the tensor-core kernel's B matrices: (name, k16 steps, n8 tiles) per layer
_FRAG_TILES = (("w1", 6, 2), ("w2", 9, 2), ("w3", 9, 4), ("wh", 2, 1))
NFRAG = sum(k * n for _, k, n in _FRAG_TILES) * 32 * 4
NWEIGHTS = NPLAIN + NFRAG   # bf16; must equal pnet_weight_count() of the source

# (name, torch shape) in packed order; conv kernels HWIO, heads [32, 6]
_LAYOUT = (("w1", (3, 3, 3, 10)), ("b1", (10,)), ("a1", (10,)),
           ("w2", (3, 3, 10, 16)), ("b2", (16,)), ("a2", (16,)),
           ("w3", (3, 3, 16, 32)), ("b3", (32,)), ("a3", (32,)),
           ("wh", (32, 6)), ("bh", (6,)))


def weight_count(dtype):
    """Length of ``pack_weights(pnet, dtype)``: NWEIGHTS for bfloat16,
    NPLAIN otherwise."""
    return NWEIGHTS if dtype == torch.bfloat16 else NPLAIN


def pack_weights(pnet, dtype):
    """PNet module -> the kernel's float32 weight vector [weight_count(dtype)]:
    the plain weights (conv kernels HWIO, heads [32, 6]), then for bfloat16
    ``tc_fragments`` of them, which only the tensor-core kernel reads. Conv
    and head weights are rounded to ``dtype`` (they are conv operands);
    biases and PReLU slopes stay float32, as the JAX kernel's packing keeps
    them."""
    rnd = lambda t: t.detach().to(dtype).float()
    hwio = lambda conv: rnd(conv.weight).permute(2, 3, 1, 0)
    heads = torch.cat([rnd(pnet.reg.weight)[:, :, 0, 0],
                       rnd(pnet.cls.weight)[:, :, 0, 0]]).t()       # [32, 6]
    parts = []
    for unit in (pnet.conv1, pnet.conv2, pnet.conv3):
        parts += [hwio(unit.conv), unit.conv.bias.detach().float(),
                  unit.prelu.alpha.detach().float()]
    parts += [heads, torch.cat([pnet.reg.bias, pnet.cls.bias]).detach().float()]
    plain = torch.cat([p.reshape(-1) for p in parts])
    if dtype != torch.bfloat16:
        return plain.contiguous()
    return torch.cat([plain, tc_fragments(_unpack(plain))]).contiguous()


def packed_weights(pnet, dtype, device):
    """``pack_weights(pnet, dtype)`` on ``device``, packed once and kept on
    the module until one of its parameters is replaced or written."""
    stamp = tuple((p.data_ptr(), p._version) for p in pnet.parameters())
    cache = pnet.__dict__.setdefault("_packed_weights", {})
    key = (dtype, torch.device(device))
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = cache[key] = (stamp, pack_weights(pnet, dtype).to(device))
    return hit[1]


def gemm_matrices(p):
    """The B matrices [K, N] of the tensor-core kernel's four products, from
    ``_unpack``'s parts, in its K order: conv1 K = phase x ky x (4 columns x
    4 channels) (96; the 4th channel 0), where the even column phase weights
    columns 0..2 of the 4 it reads and the odd phase columns 1..3; conv2 and
    conv3 K = tap x 16 input channels (144; conv2's channels 10..15 0), heads
    K = 32; N padded to 16, 16, 32 and 8 with zero columns."""
    zeros = lambda *shape: torch.zeros(shape, device=p["w1"].device)
    w1 = zeros(2, 3, 4, 4, 16)
    w1[0, :, :3, :3, :10] = p["w1"]
    w1[1, :, 1:, :3, :10] = p["w1"]
    w2 = zeros(3, 3, 16, 16)
    w2[:, :, :10] = p["w2"]
    wh = zeros(32, 8)
    wh[:, :6] = p["wh"]
    return {"w1": w1.reshape(96, 16), "w2": w2.reshape(144, 16),
            "w3": p["w3"].reshape(144, 32), "wh": wh}


def tc_fragments(p):
    """``gemm_matrices`` as mma.m16n8k16 B fragments, float32 [NFRAG]: per
    (k16 step, n8 tile), per lane (g, t) = (lane // 4, lane % 4), the
    matrix rows 2t, 2t+1, 2t+8, 2t+9 of the step in column g of the tile."""
    rows = torch.tensor([[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] for t in range(4)],
                        device=p["w1"].device)
    mats = gemm_matrices(p)
    out = []
    for name, steps, tiles in _FRAG_TILES:
        b = mats[name].reshape(steps, 16, tiles, 8)[:, rows]   # [S, t, i, N, g]
        out.append(b.permute(0, 3, 4, 1, 2).reshape(-1))       # [S, N, g, t, i]
    return torch.cat(out)


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
    p = _unpack(weights.float()[:NPLAIN])
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
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be float32 or bfloat16, got %s" % dtype)
    n = weight_count(dtype)
    if (weights.device != frames_u8.device or weights.dtype != torch.float32
            or weights.shape != (n,) or not weights.is_contiguous()):
        raise ValueError("weights must be a contiguous float32 [%d] tensor on %s"
                         % (n, frames_u8.device))
    lib = _lib()
    b, h, w = frames_u8.shape[:3]
    sh, sw = level_hw
    dev = frames_u8.device
    reg = torch.empty((b, 4, ph, pw), dtype=dtype, device=dev)
    prob = torch.empty((b, ph, pw), dtype=torch.float32, device=dev)
    # levels with windows wider than 2 are pre-pooled into this scratch
    # (channels-last RGB0 pixels)
    pooled = (None if pool_windows_le2(level_hw, (h, w))
              else torch.empty((b, sh, sw, 4), dtype=dtype, device=dev))
    with torch.cuda.device(dev):   # the C entry point runs on the current device
        rc = lib.pnet_level_launch(
            frames_u8.data_ptr(), b, h, w, sh, sw,
            None if pooled is None else pooled.data_ptr(), weights.data_ptr(),
            reg.data_ptr(), prob.data_ptr(), int(dtype == torch.bfloat16),
            _cuda.stream_ptr(dev))
    _cuda.check(rc, "pnet_level")
    _cuda.count_launch(pnet_level)
    return reg, prob


pnet_level.launches = 0


def _lib():
    lib = _cuda.load(_SRC)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pnet_level_launch.argtypes = [p, i, i, i, i, i, p, p, p, p, i, p]
        lib.pnet_level_launch.restype = i
        lib.pnet_weight_count.restype = i
        lib.pnet_plain_weight_count.restype = i
        if (lib.pnet_weight_count(), lib.pnet_plain_weight_count()) != (NWEIGHTS, NPLAIN):
            raise RuntimeError("pnet_level.cu packs %d weights (%d plain), the wrapper "
                               "%d (%d)" % (lib.pnet_weight_count(),
                                            lib.pnet_plain_weight_count(), NWEIGHTS, NPLAIN))
        lib._typed = True
    return lib
