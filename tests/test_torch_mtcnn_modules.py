"""The port's PNet / RNet / ONet modules against the flax modules, on the
same seeded parameters converted by ``utils.weights.mtcnn_from_jax``.

Also home of ``jax_mtcnn_params``, the numpy-seeded parameter tree the
port's other MTCNN tests feed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.models import mtcnn as JM
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.utils.weights import mtcnn_from_jax, unflatten


def jax_mtcnn_params(seed=0, cls_shift=0.0, reg_scale=0.02):
    """MTCNN parameter tree in the JAX layout, values drawn with numpy:
    weights N(0, 0.25), PReLU slopes in [0.1, ...), cls biases N(-0.4, 0.5)
    (+ ``cls_shift`` on the face logit, so that every stage sees
    candidates), reg/landmark heads scaled by ``reg_scale``."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(0)
    shapes = {   # abstract init: only the tree's structure and shapes
        name: jax.eval_shape(net.init, key, jnp.zeros((1, s, s, 3)))["params"]
        for name, net, s in (("pnet", JM.PNet(), 12), ("rnet", JM.RNet(), 24),
                             ("onet", JM.ONet(), 48))}

    def rnd(path, a):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        x = rng.normal(0.0, 0.25, a.shape).astype(np.float32)
        if name.endswith("alpha"):
            x = np.abs(x) * 0.5 + 0.1
        if "cls" in name and name.endswith("bias"):
            x = rng.normal(-0.4, 0.5, a.shape).astype(np.float32)
            x[1] += cls_shift
        if "reg" in name or "lmk" in name:
            x = x * reg_scale
        return x

    return jax.tree_util.tree_map_with_path(rnd, shapes)


@pytest.fixture(scope="module")
def params():
    return jax_mtcnn_params(seed=0)


@pytest.fixture(scope="module")
def port(params):
    return TM.MTCNN.from_jax(params).eval()


# tolerance: float32 on both sides, different convolution algorithms
# (summation order) — the bound tests/test_models_mtcnn.py:47 sets between
# the flax modules and the torch oracle
TOL = dict(rtol=1e-4, atol=1e-5)


def test_pnet_module_matches_flax(params, port):
    x = np.random.default_rng(1).normal(0, 0.5, (2, 20, 30, 3)).astype(np.float32)
    reg, prob = JM.PNet().apply({"params": params["pnet"]}, jnp.asarray(x))
    with torch.no_grad():
        treg, tprob = port.pnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), **TOL)
    np.testing.assert_allclose(treg.permute(0, 2, 3, 1).numpy(), np.asarray(reg), **TOL)


def test_rnet_module_matches_flax(params, port):
    x = np.random.default_rng(2).normal(0, 0.5, (3, 24, 24, 3)).astype(np.float32)
    reg, prob = JM.RNet().apply({"params": params["rnet"]}, jnp.asarray(x))
    with torch.no_grad():
        treg, tprob = port.rnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), **TOL)
    np.testing.assert_allclose(treg.numpy(), np.asarray(reg), **TOL)


def test_onet_module_matches_flax(params, port):
    x = np.random.default_rng(3).normal(0, 0.5, (3, 48, 48, 3)).astype(np.float32)
    reg, lmk, prob = JM.ONet().apply({"params": params["onet"]}, jnp.asarray(x))
    with torch.no_grad():
        treg, tlmk, tprob = port.onet(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), **TOL)
    np.testing.assert_allclose(treg.numpy(), np.asarray(reg), **TOL)
    np.testing.assert_allclose(tlmk.numpy(), np.asarray(lmk), **TOL)


def test_mtcnn_from_jax_layout(params):
    """Conv kernels HWIO -> OIHW, dense [in, out] -> [out, in], PReLU slopes
    as they are; every flax leaf lands in exactly one state-dict entry."""
    sd = mtcnn_from_jax(params)
    k = params["rnet"]["conv2"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["rnet"]["conv2.conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = params["onet"]["dense5"]["kernel"]
    np.testing.assert_array_equal(sd["onet"]["dense5.weight"].numpy(), d.T)
    np.testing.assert_array_equal(sd["pnet"]["conv1.prelu.alpha"].numpy(),
                                  params["pnet"]["conv1"]["prelu"]["alpha"])
    n_leaves = len(jax.tree.leaves(params))
    assert sum(len(v) for v in sd.values()) == n_leaves
    model = TM.MTCNN()
    for net in ("pnet", "rnet", "onet"):
        assert set(sd[net]) == set(getattr(model, net).state_dict())


def mtcnn_to_jax(model):
    """Inverse of ``mtcnn_from_jax``: an ``MTCNN`` module -> the JAX package's
    parameter tree (OIHW -> HWIO, [out, in] -> [in, out])."""
    flat = {}
    for net in ("pnet", "rnet", "onet"):
        for key, val in getattr(model, net).state_dict().items():
            val = val.detach().float().numpy()
            parts = [net] + key.split(".")
            if parts[-1] == "weight":
                parts[-1] = "kernel"
                val = val.transpose(2, 3, 1, 0) if val.ndim == 4 else val.T
            flat["/".join(parts)] = np.ascontiguousarray(val)
    return unflatten(flat)


def test_mtcnn_to_jax_round_trip(params):
    """The JAX tree -> ``MTCNN.from_jax`` -> back to the JAX layout is the
    identity: every converted entry lands in the module unchanged."""
    back = mtcnn_to_jax(TM.MTCNN.from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_seeded_init_is_reproducible():
    a, b = TM.MTCNN.seeded(3), TM.MTCNN.seeded(3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    c = TM.MTCNN.seeded(4)
    assert not torch.equal(a.pnet.conv1.conv.weight, c.pnet.conv1.conv.weight)
