"""Frozen copy of the port's ops/anchors.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import math

import numpy as np


def make_anchors(dims, scales=(1,), ratios=(1,)):
    """For every (D, S, R) in dims x scales x ratios, a (w, h) pair with area
    (D*S)^2 and aspect ratio R. Returns len(dims) lists of tuples.
    Reference: operations/anchor.py:6-17."""
    mult = [math.sqrt(ar) for ar in ratios]
    return [[(d * s * m, d * s / m) for m in mult for s in scales] for d in dims]


def get_priors(img_size, bases, loc="center", patches="as_is", concat=True):
    """Grid of (cx, cy, w, h) priors for each (stride, anchors) pair in ``bases``.

    Walks stride-sized patches of the ``img_size`` canvas left-right, top-bottom
    and places each anchor at the patch center (or top-left corner for
    loc='corner'). Returns float32 numpy array(s): [N, 4] per level, or the
    concatenation. Reference: operations/anchor.py:20-64.
    """
    assert loc in ("center", "corner")
    assert patches in ("as_is", "fit")
    h, w = img_size
    if isinstance(bases[0][1][0], (int, float)):
        bases = [(s, [(a, a) for a in l]) for (s, l) in bases]
    out = []
    for stride, anchors in bases:
        nx = math.ceil(w / stride)
        ny = math.ceil(h / stride)
        step_x = stride if patches == "as_is" else w // nx
        step_y = stride if patches == "as_is" else h // ny
        xs = np.arange(nx, dtype=np.float32) * step_x
        ys = np.arange(ny, dtype=np.float32) * step_y
        if loc == "center":
            xs = xs + step_x / 2
            ys = ys + step_y / 2
        gx, gy = np.meshgrid(xs, ys)                       # 'xy' indexing: row-major over y
        c = np.stack([gx, gy], axis=-1).reshape(-1, 2)     # [ny*nx, 2]
        c = np.repeat(c, len(anchors), axis=0)
        s = np.tile(np.asarray(anchors, dtype=np.float32), (nx * ny, 1))
        out.append(np.hstack([c, s]).astype(np.float32))
    if not concat:
        return out
    return np.concatenate(out, axis=0)
