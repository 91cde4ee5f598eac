"""The port's ``pnet_level`` (pool + whole PNet over one pyramid level)
against the JAX package: the two Pallas kernels it replaces, run in
interpret mode as tests/test_models_mtcnn.py runs them, and the flax module
on the integral-pooled level. The CUDA kernel is held against this plain
version on the card in tests/test_torch_cuda.py.

Tolerances. float32: rtol 1e-4 / atol 1e-6 — float32 accumulation order
only. bfloat16: rtol 0.05 / atol 5e-3 — one ulp of f32 summation order can
move a bf16-rounded map by one bf16 ulp, and that compounds through the four
bf16-stored maps (pool1, conv2, conv3, reg). These are the bounds the JAX
package sets between its own two dot blockings of the same kernel
(tests/test_models_mtcnn.py:699-706), for the same reason."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.models import mtcnn as JM
from videotofaces_tpu.ops import resize as JR
from videotofaces_tpu.ops.pallas_pnet import (pack_pnet_weights_r4,
                                              pad_frames_chw16, phase_block_w,
                                              pnet_level, pnet_level_fused)
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.ops import pnet_kernel as PK

from test_torch_mtcnn_modules import jax_mtcnn_params

H, W = 40, 56
UP = (int(H * 2.4 + 1), int(W * 2.4 + 1))   # upscaled: windows <= 2 wide
DOWN = (15, 21)                             # downscaled: windows 2-3 wide
TOLS = {"float32": dict(rtol=1e-4, atol=1e-6),
        "bfloat16": dict(rtol=0.05, atol=5e-3)}


@pytest.fixture(scope="module")
def setup():
    params = jax_mtcnn_params(seed=0)
    frames = np.random.default_rng(5).integers(0, 256, (1, H, W, 3)).astype(np.uint8)
    return params, frames, TM.MTCNN.from_jax(params)


def _port(setup, level_hw, dtype):
    _, frames, model = setup
    w = PK.pack_weights(model.pnet, dtype)
    reg, prob = PK.pnet_level(torch.from_numpy(frames), level_hw, w, dtype)
    return reg.float().numpy(), prob.numpy()


def _jax_dtype(name):
    return jnp.float32 if name == "float32" else jnp.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_fused_pool_kernel(setup, dtype):
    """Upscaled level: ``pnet_level_fused`` pools the normalized frame in
    the kernel (<= 2-wide windows)."""
    params, frames, _ = setup
    assert JR.pool_windows_le2(UP, (H, W))
    dt = _jax_dtype(dtype)
    fnorm = jnp.transpose(JM._normalize(
        jnp.asarray(frames)[..., ::-1].astype(jnp.float32)), (0, 3, 1, 2))
    reg, prob = pnet_level_fused(pack_pnet_weights_r4(params["pnet"], dt),
                                 pad_frames_chw16(fnorm.astype(dt)), (H, W), UP,
                                 to=8, interpret=True)
    treg, tprob = _port(setup, UP, getattr(torch, dtype))
    np.testing.assert_allclose(tprob, np.asarray(prob, np.float32), **TOLS[dtype])
    np.testing.assert_allclose(treg, np.asarray(reg, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_prepooled_kernel(setup, dtype):
    """Downscaled level: ``pnet_level`` on the level pooled by
    ``adaptive_pool_full_phase_mm01``, as the JAX cascade feeds it."""
    params, frames, _ = setup
    assert not JR.pool_windows_le2(DOWN, (H, W))
    dt = _jax_dtype(dtype)
    u8_chw = jnp.transpose(jnp.asarray(frames)[..., ::-1], (0, 3, 1, 2)).astype(dt)
    level = JM._normalize(JR.adaptive_pool_full_phase_mm01(u8_chw, DOWN, (H, W))).astype(dt)
    assert level.shape[-1] == 2 * phase_block_w(DOWN[1])
    reg, prob = pnet_level(pack_pnet_weights_r4(params["pnet"], dt), level, DOWN,
                           to=8, interpret=True)
    treg, tprob = _port(setup, DOWN, getattr(torch, dtype))
    np.testing.assert_allclose(tprob, np.asarray(prob, np.float32), **TOLS[dtype])
    np.testing.assert_allclose(treg, np.asarray(reg, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("level_hw", [UP, DOWN], ids=["up", "down"])
def test_plain_matches_flax_module_on_integral_pool(setup, level_hw):
    """float32: the flax PNet on the integral-image pooled level (the JAX
    parity path)."""
    params, frames, _ = setup
    ii = JR.integral_image(jnp.asarray(frames)[..., ::-1])
    level = JM._normalize(JR.adaptive_pool_full(ii, level_hw, (H, W)))
    reg, prob = JM.PNet().apply({"params": params["pnet"]}, level)
    treg, tprob = _port(setup, level_hw, torch.float32)
    np.testing.assert_allclose(tprob, np.asarray(prob), **TOLS["float32"])
    np.testing.assert_allclose(treg, np.asarray(reg).transpose(0, 3, 1, 2),
                               **TOLS["float32"])


def test_geometry_and_validation(setup):
    """Unpadded outputs of PH = ceil((SH-2)/2) - 4 by PW; levels too small
    for PNet and non-uint8 frames are refused."""
    _, frames, model = setup
    w = PK.pack_weights(model.pnet, torch.float32)
    assert w.shape == (PK.NWEIGHTS,)
    x = torch.from_numpy(frames)
    for sh, sw in [(15, 27), (14, 14), UP]:
        reg, prob = PK.pnet_level(x, (sh, sw), w, torch.float32)
        ph, pw = -(-(sh - 2) // 2) - 4, -(-(sw - 2) // 2) - 4
        assert reg.shape == (1, 4, ph, pw) and prob.shape == (1, ph, pw)
    with pytest.raises(ValueError):
        PK.pnet_level(x, (10, 20), w, torch.float32)
    with pytest.raises(ValueError):
        PK.pnet_level(x.float(), (20, 20), w, torch.float32)
    assert PK.pnet_level.launches == 0   # the CPU path never counts a launch
