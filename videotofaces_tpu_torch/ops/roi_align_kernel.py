"""Multilevel RoIAlign (K4): the launch wrapper of the CUDA kernel
``csrc/roi_align.cu``.

Replaces the JAX package's Pallas kernel ``ops/pallas_roialign.py::
roi_align_patches`` and its launcher ``ops/roi_align.py::
roi_align_multilevel_pallas``. ``ops/roi_align.py::roi_align_fpn`` calls it
for tensors on the card and runs the plain version
(``roi_align_fpn_plain``) for tensors on the CPU; the contract is there.
The kernel's bound and design are in the source's header.
"""

import ctypes

import torch

from . import _cuda

_SRC = "roi_align.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def roi_align_cuda(fmaps, boxes, levels, valid, strides):
    """Launch K4 on the card. fmaps: four [B, H_l, W_l, C] contiguous CUDA
    tensors of one dtype (float32 or bfloat16); boxes [B, R, 4] float32;
    levels [B, R] int32 in 0..3 (``assign_fpn_levels``); valid [B, R] bool.
    Returns [B, R, 7, 7, C] float32, zero where not valid. Raises on
    anything the kernel does not take."""
    from .roi_align import OUT_SIZE, _check, inv_out

    _check(fmaps, boxes, valid, strides)
    if len(fmaps) != 4:
        raise ValueError("the kernel pools from exactly four levels, got %d" % len(fmaps))
    dev = boxes.device
    tensors = list(fmaps) + [boxes, levels, valid]
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("feature maps, boxes, levels and valid must be contiguous on %s"
                         % dev)
    if fmaps[0].dtype not in _DTYPES:
        raise ValueError("feature maps must be float32 or bfloat16, not %s" % fmaps[0].dtype)
    if levels.dtype != torch.int32 or levels.shape != valid.shape:
        raise ValueError("levels must be int32 [B, R], got %s %s"
                         % (levels.dtype, tuple(levels.shape)))
    b, r = boxes.shape[:2]
    c = fmaps[0].shape[-1]
    out = torch.empty((b, r, OUT_SIZE, OUT_SIZE, c), dtype=torch.float32, device=dev)
    if b * r == 0:           # nothing to launch, nothing to count
        return out
    hw = (ctypes.c_int * 8)(*[int(s) for f in fmaps for s in f.shape[1:3]])
    scales = (ctypes.c_float * 4)(*[1.0 / s for s in strides])
    lib = _lib()
    with torch.cuda.device(dev):   # the C entry point runs on the current device
        rc = lib.roi_align_launch(*[f.data_ptr() for f in fmaps], hw, scales,
                                  _DTYPES[fmaps[0].dtype], b, r, c, boxes.data_ptr(),
                                  levels.data_ptr(), valid.data_ptr(), inv_out(OUT_SIZE),
                                  out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(rc, "roi_align")
    _cuda.count_launch(roi_align_cuda)
    return out


roi_align_cuda.launches = 0


def _lib():
    lib = _cuda.load(_SRC)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.roi_align_launch.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_float), i, i, i, i,
                                         p, p, p, f, p, p]
        lib.roi_align_launch.restype = i
        lib._typed = True
    return lib
