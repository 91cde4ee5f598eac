"""The port's ``pool_crops`` (MTCNN stage-2/3 crop resample) against the
JAX package: the Pallas kernel it replaces (``adaptive_pool_crops`` in
interpret mode) and the gather engine (``adaptive_pool_boxes_batched``). The
window cases are those of tests/test_pallas_crops.py. The CUDA kernel is
held against this plain version on the card in tests/test_torch_cuda.py.

Tolerances: the gather engine sums in int32 exactly as the port does, so
the two agree bit for bit; the Pallas kernel sums normalized floats in f32,
within 1e-5 of exact for these windows (ops/pallas_crops.py:30-32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.ops.pallas_crops import (adaptive_pool_crops,
                                               bucket_limits, pad_frames_chw)
from videotofaces_tpu.ops.resize import adaptive_pool_boxes_batched, integral_image
from videotofaces_tpu_torch.ops import crops_kernel as CK


def _normalize(x):
    return (x - 127.5) / 128.0


def _pallas(frames_u8, scal, out, win_hw):
    chw = jnp.transpose(_normalize(jnp.asarray(frames_u8[..., ::-1], jnp.float32)),
                        (0, 3, 1, 2))
    return np.asarray(adaptive_pool_crops(pad_frames_chw(chw), jnp.asarray(scal),
                                          out, win_hw, interpret=True))


def _gather(frames_u8, scal, out):
    ii = integral_image(jnp.asarray(frames_u8[..., ::-1]))
    wins = np.stack([scal[:, 2], scal[:, 1], scal[:, 2] + scal[:, 4],
                     scal[:, 1] + scal[:, 3]], axis=1).astype(np.int32)
    return np.asarray(_normalize(adaptive_pool_boxes_batched(
        ii, jnp.asarray(wins), jnp.asarray(scal[:, 0]), (out, out))))


def _port(frames_u8, scal, out):
    return CK.pool_crops(torch.from_numpy(frames_u8),
                         torch.from_numpy(scal.astype(np.int32)), out).numpy()


def _case_random(rng):
    b, h, w = 2, 40, 56
    frames = rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8)
    scal = []
    for k in range(24):
        ok = 0 if k % 7 == 3 else 1
        wh, ww = int(rng.integers(1, 17)), int(rng.integers(1, 25))
        y1, x1 = int(rng.integers(0, h - wh + 1)), int(rng.integers(0, w - ww + 1))
        scal.append((int(rng.integers(0, b)), y1, x1, wh, ww, ok))
    return frames, np.asarray(scal, np.int32), 5, bucket_limits((h, w), (16, 24))


def _case_upsampling(rng):
    frames = rng.integers(0, 256, size=(1, 30, 30, 3)).astype(np.uint8)
    scal = np.asarray([[0, 4, 6, 3, 2, 1]], np.int32)  # 3x2 window -> 8x8
    return frames, scal, 8, bucket_limits((30, 30), (8, 8))


def _case_full_frame(rng):
    h, w = 37, 130
    frames = rng.integers(0, 256, size=(1, h, w, 3)).astype(np.uint8)
    wins = [(0, 0, w, h), (3, 5, w, h), (1, 30, 128, 37)]
    scal = np.asarray([[0, y1, x1, y2 - y1, x2 - x1, 1]
                       for (x1, y1, x2, y2) in wins], np.int32)
    return frames, scal, 6, bucket_limits((h, w), (h, w))


CASES = {"random": _case_random, "upsampling": _case_upsampling,
         "full_frame": _case_full_frame}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_gather_engine_exactly(case):
    frames, scal, out, _ = CASES[case](np.random.default_rng(0))
    got, want = _port(frames, scal, out), _gather(frames, scal, out)
    live = scal[:, 5] != 0
    np.testing.assert_array_equal(got[live], want[live])
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case):
    frames, scal, out, win_hw = CASES[case](np.random.default_rng(0))
    np.testing.assert_allclose(_port(frames, scal, out),
                               _pallas(frames, scal, out, win_hw),
                               rtol=1e-5, atol=1e-5)


def test_out_of_frame_slots_are_zero():
    """A slot whose window leaves the frame (or names no image) is dead,
    like ok == 0: zeros, never an out-of-bounds read."""
    frames = np.random.default_rng(1).integers(0, 256, (1, 20, 30, 3)).astype(np.uint8)
    scal = np.asarray([[0, 15, 0, 6, 4, 1], [0, 0, 28, 3, 3, 1],
                       [1, 0, 0, 3, 3, 1], [0, -1, 0, 3, 3, 1],
                       [0, 0, 0, 0, 3, 1], [0, 2, 3, 4, 5, 1]], np.int32)
    got = _port(frames, scal, 4)
    assert np.all(got[:5] == 0.0)
    np.testing.assert_array_equal(got[5], _gather(frames, scal[5:], 4)[0])
    assert CK.pool_crops.launches == 0   # the CPU path never counts a launch
