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
import torch.nn.functional as F

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
    assert w.shape == (PK.weight_count(torch.float32),) == (PK.NPLAIN,)
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


def _frag_inverse(frags):
    """{layer: [K, N]} read back from the B-fragment vector lane by lane, as
    mma.m16n8k16 hands lane (g, t) the rows 2t, 2t+1, 2t+8, 2t+9 of column
    g of each (k16 step, n8 tile)."""
    out, o = {}, 0
    for name, steps, tiles in PK._FRAG_TILES:
        mat = torch.full((steps * 16, tiles * 8), float("nan"))
        for s in range(steps):
            for n in range(tiles):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for i, row in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                        mat[s * 16 + row, n * 8 + g] = frags[o + lane * 4 + i]
                o += 128
        out[name] = mat
    assert o == PK.NFRAG
    return out


def test_tc_fragments_hold_the_gemm_matrices_of_the_convolutions():
    """The tensor-core kernel's B fragments, read back lane by lane, are its
    implicit-GEMM matrices, and those matrices, applied to the patches in the
    kernel's K order, are the convolutions and the heads."""
    pnet = TM.MTCNN.seeded(0).pnet
    w = PK.pack_weights(pnet, torch.bfloat16)
    assert w.shape == (PK.NWEIGHTS,) and PK.NWEIGHTS == PK.NPLAIN + PK.NFRAG
    p = PK._unpack(w[:PK.NPLAIN])
    mats = _frag_inverse(w[PK.NPLAIN:])
    for name, want in PK.gemm_matrices(p).items():
        torch.testing.assert_close(mats[name], want, rtol=0, atol=0)
    rng = np.random.default_rng(3)
    x = lambda c: torch.from_numpy(rng.normal(0, 1, (1, c, 9, 11)).astype(np.float32))
    conv = lambda v, k: F.conv2d(v, k.permute(3, 2, 0, 1))[0].permute(1, 2, 0)
    # conv1: K = ky x (4 columns x 4 channels); the even column phase reads
    # columns x..x+3 for output x, the odd phase x-1..x+2
    x1 = x(3)
    xp = F.pad(x1, (1, 1, 0, 0))[0]                                  # [3, 9, 13]
    xp = torch.cat([xp, torch.zeros_like(xp[:1])])                   # [4, 9, 13]
    want = conv(x1, p["w1"])                                         # [7, 9, 10]
    for phase, first in ((0, 1), (1, 0)):   # padded column of output 0's view
        a1 = torch.stack([xp[c, ky:ky + 7, first + kx:first + kx + 9] for ky in range(3)
                          for kx in range(4) for c in range(4)], -1)
        torch.testing.assert_close(a1 @ mats["w1"][48 * phase:48 * (phase + 1), :10], want)
    assert (mats["w1"][:, 10:] == 0).all()
    # conv2, conv3: K = tap x 16 channels (conv2's channels 10..15 zero)
    for name, cin in (("w2", 10), ("w3", 16)):
        xi = x(cin)
        x16 = torch.cat([xi[0], torch.zeros((16 - cin, 9, 11))])
        a = torch.stack([x16[c, ky:ky + 7, kx:kx + 9] for ky in range(3)
                         for kx in range(3) for c in range(16)], -1)
        n = p[name].shape[-1]
        torch.testing.assert_close(a @ mats[name][:, :n], conv(xi, p[name]))
    torch.testing.assert_close(mats["wh"][:, :6], p["wh"], rtol=0, atol=0)
    assert (mats["wh"][:, 6:] == 0).all()


def test_packed_weights_pack_once_per_module_and_dtype():
    pnet = TM.MTCNN.seeded(0).pnet
    a = PK.packed_weights(pnet, torch.bfloat16, "cpu")
    assert PK.packed_weights(pnet, torch.bfloat16, "cpu") is a
    torch.testing.assert_close(a, PK.pack_weights(pnet, torch.bfloat16), rtol=0, atol=0)
    f = PK.packed_weights(pnet, torch.float32, "cpu")
    assert f is not a and f.dtype == torch.float32 and f.shape == (PK.NPLAIN,)
    assert a.shape == (PK.weight_count(torch.bfloat16),) == (PK.NWEIGHTS,)
    with torch.no_grad():
        pnet.conv1.conv.weight.mul_(2.0)   # a write repacks
    b = PK.packed_weights(pnet, torch.bfloat16, "cpu")
    assert b is not a
    torch.testing.assert_close(b, PK.pack_weights(pnet, torch.bfloat16), rtol=0, atol=0)
