"""K5, the encoder's resize-normalize: the port's plain version (the CPU path
of ``ops/resize_kernel.resize_normalize``) against the JAX package's Pallas
kernel ``resize_normalize_chw_u8`` in interpret mode, and the port's
``pack_images`` against the JAX package's.

The port packs HWC and returns NCHW where the JAX kernel packs CHW and
returns NHWC; the tests permute to compare."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.ops import pallas_resize as PR
from videotofaces_tpu_torch.ops import resize_kernel as RK

SHAPES = [(1, 1), (1, 37), (41, 1), (64, 64), (97, 211), (200, 150), (256, 256),
          (800, 600)]


@pytest.fixture(scope="module")
def packed():
    rng = np.random.default_rng(21)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SHAPES]
    return imgs, RK.pack_images(imgs, 256)


def test_pack_images_matches_jax(packed):
    imgs, (port, sizes) = packed
    want, want_sizes = PR.pack_images(imgs, 256)
    assert port.shape == (len(imgs), 256, 256, 3) and sizes.dtype == np.int32
    np.testing.assert_array_equal(port.transpose(0, 3, 1, 2), want)
    np.testing.assert_array_equal(sizes, want_sizes)
    assert tuple(sizes[-1]) == (256, 192)          # the 800x600 crop, pre-shrunk


@pytest.mark.parametrize("out", [160, 128])
@pytest.mark.parametrize("swap_rb", [True, False], ids=["bgr2rgb", "noswap"])
def test_resize_normalize_plain_matches_jax_kernel(packed, out, swap_rb):
    _, (port, sizes) = packed
    want = np.asarray(PR.resize_normalize_chw_u8(
        jnp.asarray(port.transpose(0, 3, 1, 2)), jnp.asarray(sizes), out_size=out,
        scale=1 / 128.0, mean=127.5, swap_rb=swap_rb, interpret=True))
    got = RK.resize_normalize(torch.from_numpy(port), torch.from_numpy(sizes), out,
                              1 / 128.0, 127.5, swap_rb)
    assert got.shape == (len(SHAPES), 3, out, out) and got.dtype == torch.float32
    # the same tap weights; the sums differ by summation order only
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [1, 37, 97, 200, 211, 256])
def test_hat_weights_equal_jitted_jax(size):
    """The coordinate is computed as XLA compiles the JAX kernel's (a fused
    product with the float32 reciprocal of ``out``), so the matrices are
    equal bit for bit."""
    want = np.asarray(jax.jit(PR._weights, static_argnums=(1, 2))(jnp.int32(size), 160, 256))
    got = RK.hat_weights(torch.tensor([size], dtype=torch.int32), 160, 256)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_normalize_cpu_checks_inputs():
    packed = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        RK.resize_normalize(packed, torch.ones((2, 2), dtype=torch.int64), 16, 1.0, 0.0)
    with pytest.raises(ValueError):
        RK.resize_normalize(packed.permute(0, 3, 1, 2), torch.ones((2, 2), dtype=torch.int32),
                            16, 1.0, 0.0)
    # the CPU path is the plain version: the launch count does not move
    n0 = RK.resize_normalize.launches
    out = RK.resize_normalize(packed, torch.full((2, 2), 32, dtype=torch.int32), 16,
                              1 / 128.0, 127.5)
    assert out.shape == (2, 3, 16, 16) and RK.resize_normalize.launches == n0
