"""The port's ViT and ``VitEncoder`` against the JAX package's, jitted, on the
same numpy-seeded parameters converted by ``utils.weights.vit_from_jax``,
in precision "highest".

Also home of ``jax_vit_params``, the parameter tree the port's anime-path
tests feed to both packages."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.models import layers as JL
from videotofaces_tpu.models import vit as JV
from videotofaces_tpu.models.wrappers import VitEncoder as JaxEncoder
from videotofaces_tpu.ops import pallas_resize as PR
from videotofaces_tpu_torch.models import layers as TL
from videotofaces_tpu_torch.models import vit as TV
from videotofaces_tpu_torch.models.wrappers import VitEncoder
from videotofaces_tpu_torch.utils.weights import vit_from_jax

from test_torch_facenet import few_threads  # noqa: F401

# float32 on both sides, other summation orders through 2 or 12 blocks; the
# embeddings are LayerNorm'd (entries O(1))
EMB_TOL = dict(rtol=0, atol=2e-4)


def jax_vit_params(seed=0, dim=768, depth=12):
    """ViT parameter tree in the JAX layout, drawn with numpy: dense and
    patch kernels N(0, 1/fan_in), biases N(0, 0.02), LayerNorm scale
    1 + N(0, 0.1) and bias N(0, 0.1), class token N(0, 0.5) and positional
    embedding N(0, 0.1) — random tokens, so that different crops embed
    apart."""
    shapes = jax.eval_shape(JV.ViT(dim=dim, depth=depth).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))["params"]
    rng = np.random.default_rng(seed)

    def rnd(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        name = keys[-1]
        if name == "kernel":
            sd = np.sqrt(1.0 / np.prod(a.shape[:-1]))
        elif name == "class_token":
            sd = 0.5
        elif name in ("pos_embedding", "scale") or keys[-2].startswith("norm"):
            sd = 0.1
        else:
            sd = 0.02
        x = rng.normal(0.0, sd, a.shape)
        return (x + 1.0 if name == "scale" else x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(rnd, shapes)


@pytest.fixture(scope="module")
def small():
    return jax_vit_params(1, dim=128, depth=2)


@pytest.fixture(scope="module")
def b16():
    return jax_vit_params(2)


@pytest.fixture(scope="module")
def crops():
    """Five crops of mixed sizes (one larger than the 256 px pack slot)."""
    rng = np.random.default_rng(4)
    out = []
    for h, w in [(66, 66), (120, 97), (40, 52), (128, 128), (300, 280)]:
        low = rng.integers(0, 256, (6, 6, 3)).astype(np.uint8)
        img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
        img += rng.integers(-10, 11, img.shape, dtype=np.int16)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def test_vit_from_jax_layout(small):
    sd = vit_from_jax(small)
    np.testing.assert_array_equal(sd["patch_embedding.weight"].numpy(),
                                  small["patch_embedding"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["block1.attn.k.weight"].numpy(),
                                  small["block1"]["attn"]["k"]["kernel"].T)
    np.testing.assert_array_equal(sd["block0.norm2.weight"].numpy(),
                                  small["block0"]["norm2"]["scale"])
    np.testing.assert_array_equal(sd["class_token"].numpy(), small["class_token"])
    assert set(sd) == set(TV.ViT(dim=128, depth=2).state_dict())


def test_small_vit_matches_flax(small):
    """dim 128 (2 heads), depth 2: patch order, class token, attention scale
    head_dim^-0.5, exact GELU, LayerNorm eps 1e-12."""
    x = np.random.default_rng(5).normal(0, 1, (3, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JV.ViT(dim=128, depth=2).apply)({"params": small}, x))
    model = TV.ViT.from_jax(small, dim=128, depth=2).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == (3, 128)
    np.testing.assert_allclose(got, want, **EMB_TOL)


def test_layernorm_and_gelu_match_flax():
    rng = np.random.default_rng(6)
    x = rng.normal(3.0, 2.0, (4, 33)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 33).astype(np.float32),
         "bias": rng.normal(0, 0.1, 33).astype(np.float32)}
    want = np.asarray(jax.jit(JL.LayerNorm(33).apply)({"params": p}, x))
    ln = TL.LayerNorm(33).eval()
    assert ln.eps == 1e-12
    ln.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-5)
    g = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    np.testing.assert_allclose(torch.nn.functional.gelu(torch.from_numpy(x)).numpy(), g,
                               rtol=1e-6, atol=1e-6)


def test_vit_b16_and_l16_sizes():
    counts = []
    for make, port, want_dim in ((JV.vit_b16, TV.vit_b16, 768), (JV.vit_l16, TV.vit_l16, 1024)):
        shapes = jax.eval_shape(make().init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
        n = sum(a.size for a in jax.tree_util.tree_leaves(shapes["params"]))
        with torch.device("meta"):
            model = port()
        counts.append(sum(p.numel() for p in model.parameters()))
        assert counts[-1] == n
        assert model.norm.normalized_shape == (want_dim,)
    assert counts == [85_697_280, 303_166_464]       # B16, L16 at 128 px
    np.testing.assert_array_equal(
        TV.preprocess_uint8(torch.tensor([0, 127, 255], dtype=torch.uint8)).numpy(),
        np.asarray(JV.preprocess_uint8(jnp.asarray([0, 127, 255], jnp.uint8))))


def test_encoder_host_path_matches_jax(b16, crops):
    """ViT-B16: per-crop cv2 resize to 128, padding to the batch size by
    repeating the last crop, BGR -> RGB, (x - 127.5) / 127.5, forward."""
    jenc = JaxEncoder(params=b16, batch_size=4)
    enc = VitEncoder(device="cpu", params=b16, batch_size=4)
    assert enc.device.type == "cpu" and enc.input_size == 128
    for part in (crops[:4], crops[4:]):      # the second batch is padded 1 -> 4
        got = enc(part)
        assert got.shape == (len(part), 768)
        np.testing.assert_allclose(got, jenc(part), **EMB_TOL)


def test_encoder_device_resize_path_matches_jax(b16, crops):
    """``device_resize=True``: the crops packed and resized by K5 at out 128
    with the ViT affine (its plain version on the CPU), against the JAX
    ViT-B16 on the JAX K5 kernel's output in interpret mode."""
    packed, sizes = PR.pack_images(crops, 256)
    x = PR.resize_normalize_chw_u8(jnp.asarray(packed), jnp.asarray(sizes), 128,
                                   1 / 127.5, 127.5, swap_rb=True, interpret=True)
    want = np.asarray(jax.jit(JV.vit_b16().apply)({"params": b16}, x))
    enc = VitEncoder(device="cpu", params=b16, batch_size=8, device_resize=True)
    got = enc(crops)
    assert got.shape == (5, 768)
    np.testing.assert_allclose(got, want, **EMB_TOL)
    # the seeded tokens embed different crops apart
    n = got / np.linalg.norm(got, axis=1, keepdims=True)
    assert (1 - n @ n.T)[np.triu_indices(5, 1)].min() > 0.05
