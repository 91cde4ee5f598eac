"""The port's FaceNet (InceptionResnetV1) and ``FaceNetEncoder`` against the
JAX package's, on the same numpy-seeded parameters converted by
``utils.weights.facenet_from_jax``, in precision "highest".

Also home of ``jax_facenet_params``, the parameter tree the port's grouping
tests feed to both packages."""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.models import facenet as JF
from videotofaces_tpu.models import layers as JL
from videotofaces_tpu.models.wrappers import FaceNetEncoder as JaxEncoder
from videotofaces_tpu.ops import pallas_resize as PR
from videotofaces_tpu_torch.models import facenet as TF
from videotofaces_tpu_torch.models import layers as TL
from videotofaces_tpu_torch.models.wrappers import FaceNetEncoder
from videotofaces_tpu_torch.utils.weights import facenet_from_jax

# float32 on both sides, different convolution algorithms (summation order)
# through 130 layers; the embeddings are unit vectors
EMB_TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for torch while this module runs: the suite runs
    files in parallel workers, and FaceNet on the CPU would otherwise take
    every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _jax_facenet_shapes():
    return jax.eval_shape(JF.InceptionResnetV1().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 160, 160, 3)))["params"]


def _calibration_images(n=8, seed=9):
    rng = np.random.default_rng(seed)
    return np.stack([cv2.resize(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8),
                                (160, 160), interpolation=cv2.INTER_CUBIC)
                     for _ in range(n)])


def jax_facenet_params(seed=0, calibrate=True):
    """InceptionResnetV1 parameter tree in the JAX layout, drawn with numpy:
    weights N(0, 0.05), BatchNorm scale 1 + N(0, 0.05) and var |N| + 0.5
    (random statistics, so that a bridge swapping mean and var, or scale and
    bias, fails). With ``calibrate``, ``head_bn``'s mean and var are the
    head features' statistics over 8 smooth seeded images (computed with
    the port's module): random weights otherwise embed every crop within
    ~0.005 cosine distance of every other, and the embedding dedup would
    keep one face."""
    rng = np.random.default_rng(seed)

    def rnd(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.normal(0.0, 0.05, a.shape).astype(np.float32)
        if name == "var":
            x = np.abs(x) + 0.5
        elif name == "scale":
            x = 1.0 + x
        return x

    params = jax.tree_util.tree_map_with_path(rnd, _jax_facenet_shapes())
    if calibrate:
        model = TF.InceptionResnetV1.from_jax(params).eval()
        feats = []
        hook = model.head.register_forward_hook(lambda m, i, o: feats.append(o))
        x = TF.preprocess_uint8(torch.from_numpy(_calibration_images())).permute(0, 3, 1, 2)
        with torch.no_grad():
            model(x.contiguous())
        hook.remove()
        f = feats[0].numpy().astype(np.float64)
        params["head_bn"]["mean"] = f.mean(0).astype(np.float32)
        params["head_bn"]["var"] = (f.var(0) + 1e-6).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def params():
    return jax_facenet_params(seed=0, calibrate=False)


@pytest.fixture(scope="module")
def calibrated():
    return jax_facenet_params(seed=1, calibrate=True)


@pytest.fixture(scope="module")
def crops():
    """Five crops of mixed sizes (one larger than the 256 px pack slot)."""
    rng = np.random.default_rng(4)
    out = []
    for h, w in [(66, 66), (120, 97), (40, 52), (160, 160), (300, 280)]:
        low = rng.integers(0, 256, (6, 6, 3)).astype(np.uint8)
        img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
        img += rng.integers(-10, 11, img.shape, dtype=np.int16)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def test_facenet_from_jax_layout(params):
    """Conv kernels HWIO -> OIHW, the residual ``out`` conv with its bias,
    head [1792, 512] -> [512, 1792], BatchNorm {scale, bias, mean, var} ->
    {weight, bias, running_mean, running_var}; every leaf lands once."""
    sd = facenet_from_jax(params)
    np.testing.assert_array_equal(sd["stem0.conv.weight"].numpy(),
                                  params["stem0"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["b3.out.bias"].numpy(), params["b3"]["out"]["bias"])
    np.testing.assert_array_equal(sd["head.weight"].numpy(), params["head"]["kernel"].T)
    bn = params["c2"]["b1_1"]["bn"]
    for jname, tname in [("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")]:
        np.testing.assert_array_equal(sd["c2.b1_1.bn." + tname].numpy(), bn[jname])
    np.testing.assert_array_equal(sd["head_bn.running_var"].numpy(), params["head_bn"]["var"])
    model = TF.InceptionResnetV1()
    assert set(sd) == set(model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert sum(1 for k in sd if not k.endswith("num_batches_tracked")) == len(leaves)
    # all 23.5 M parameters; the BN statistics are buffers
    n_stats = sum(a.size for path, a in leaves if path[-1].key in ("mean", "var"))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for _, a in leaves) - n_stats == 23482624


def test_conv_unit_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 11, 5)).astype(np.float32)
    unit = JL.ConvUnit(7, (1, 3), 1, (0, 1), activ="relu", bn_eps=1e-3, bias=False)
    p = jax.eval_shape(unit.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = jax.tree.map(lambda a: rng.normal(0.5, 0.3, a.shape).astype(np.float32), p)
    p["bn"]["var"] = np.abs(p["bn"]["var"]) + 0.1
    add = rng.normal(0, 1, (2, 9, 11, 7)).astype(np.float32)
    want = np.asarray(unit.apply({"params": p}, jnp.asarray(x), add=jnp.asarray(add)))
    port = TL.ConvUnit(5, 7, (1, 3), 1, (0, 1), activ="relu", bn_eps=1e-3).eval()
    port.load_state_dict({k[len("u."):]: v for k, v in facenet_from_jax({"u": p}).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   add=torch.from_numpy(add).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_facenet_module_matches_flax(params):
    x = np.random.default_rng(1).normal(0, 1, (2, 160, 160, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JF.InceptionResnetV1().apply)({"params": params},
                                                           jnp.asarray(x)))
    model = TF.InceptionResnetV1.from_jax(params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, **EMB_TOL)


def test_encoder_host_path_matches_jax(calibrated, crops):
    """Per-crop cv2 resize, padding to the batch size by repeating the last
    crop, BGR -> RGB, normalize, forward."""
    jenc = JaxEncoder(params=calibrated, batch_size=4)
    enc = FaceNetEncoder(device="cpu", params=calibrated, batch_size=4)
    assert enc.device.type == "cpu"
    for part in (crops[:4], crops[4:]):      # the second batch is padded 1 -> 4
        got = enc(part)
        assert got.shape == (len(part), 512)
        np.testing.assert_allclose(got, jenc(part), **EMB_TOL)


def test_encoder_device_resize_path_matches_jax(calibrated, crops):
    """``device_resize=True``: the crops packed and resized by K5 (its plain
    version on the CPU), against the JAX FaceNet on the JAX K5 kernel's
    output in interpret mode."""
    packed, sizes = PR.pack_images(crops, 256)
    x = PR.resize_normalize_chw_u8(jnp.asarray(packed), jnp.asarray(sizes), 160,
                                   1 / 128.0, 127.5, swap_rb=True, interpret=True)
    want = np.asarray(jax.jit(JF.InceptionResnetV1().apply)({"params": calibrated}, x))
    enc = FaceNetEncoder(device="cpu", params=calibrated, batch_size=8,
                         device_resize=True, pack_size=256)
    got = enc(crops)
    assert got.shape == (5, 512)
    np.testing.assert_allclose(got, want, **EMB_TOL)
    # calibrated embeddings spread: no two crops within the dedup threshold
    d = 1 - got @ got.T
    assert d[np.triu_indices(5, 1)].min() > 0.25


def test_seeded_init_is_reproducible():
    a, b = TF.InceptionResnetV1.seeded(3), TF.InceptionResnetV1.seeded(3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert sum(p.numel() for p in a.parameters()) == 23482624


def test_preprocess_affine_matches_jax():
    u8 = np.array([[[[0, 127, 255]]]], dtype=np.uint8)
    np.testing.assert_array_equal(TF.preprocess_uint8(torch.from_numpy(u8)).numpy(),
                                  np.asarray(JF.preprocess_uint8(jnp.asarray(u8))))
