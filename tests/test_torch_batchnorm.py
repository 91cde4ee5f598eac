"""The port's BatchNorm is the JAX package's ``BatchNormInference`` in either
module mode: a model in ``.train()`` returns what it returns in ``.eval()``
(bit for bit) and leaves its statistics alone — YOLOv3, FaceNet and the
ResNet. With statistics that require grad, the module computes the JAX
formula as explicit ops, which agree with the inference path and with the
JAX layer, and autograd reaches all four leaves, as ``jax.grad`` does.

Tolerances: train vs eval exact; the explicit formula vs
``F.batch_norm`` and vs the JAX layer rtol 1e-6, atol 1e-6 (float32, one
normalization); gradients vs ``jax.grad`` rtol 1e-5, atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.models import layers as JL
from videotofaces_tpu_torch.models import facenet as TF
from videotofaces_tpu_torch.models import layers as TL
from videotofaces_tpu_torch.models import resnet as TRES
from videotofaces_tpu_torch.models import yolo as TY

from test_torch_facenet import few_threads  # noqa: F401


def _random_stats(model, seed):
    """Statistics away from their init, so that normalizing by batch
    statistics would show."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            x = torch.from_numpy(rng.normal(0, 0.2, tuple(buf.shape)).astype(np.float32))
            buf.copy_(x.abs() + 0.5 if name.endswith("running_var") else x)
    return model


MODELS = {
    "yolo": (lambda: TY.YOLOv3.seeded(0), (2, 3, 64, 64)),
    "facenet": (lambda: TF.InceptionResnetV1.seeded(0), (2, 3, 75, 75)),
    "resnet": (lambda: TRES.ResNet((1, 1, 1, 1)), (2, 3, 64, 64)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_mode_computes_what_eval_computes(name):
    make, shape = MODELS[name]
    model = _random_stats(make(), 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, shape).astype(np.float32))
    before = {k: v.clone() for k, v in model.named_buffers()}
    assert len(before) > 0
    with torch.no_grad():
        want = model.eval()(x)
        got = model.train()(x)
    for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                    want if isinstance(want, (list, tuple)) else [want]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for k, v in model.named_buffers():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert not any(k.endswith("num_batches_tracked") for k in model.state_dict())


def _jax_bn(rng, c, eps):
    p = {"scale": rng.normal(1, 0.1, c), "bias": rng.normal(0, 0.1, c),
         "mean": rng.normal(0, 0.3, c), "var": np.abs(rng.normal(0, 0.3, c)) + 0.4}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("rank", [2, 4], ids=["head_bn", "conv_bn"])
def test_statistics_get_gradients_as_in_jax(rank):
    rng = np.random.default_rng(3)
    c, eps = 6, 1e-3
    p = _jax_bn(rng, c, eps)
    x = rng.normal(0, 1, (3, 5, 4, c) if rank == 4 else (3, c)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)       # d(loss)/d(out)
    layer = JL.BatchNormInference(c, eps)

    def loss(params, xx):
        return jnp.sum(layer.apply({"params": params}, xx) * w)

    want_out = np.asarray(layer.apply({"params": p}, x))
    want_grads = jax.grad(loss)(p, x)

    bn = TL.BatchNorm(c, eps)
    with torch.no_grad():
        for tname, jname in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, tname).copy_(torch.from_numpy(p[jname]))
    xt = torch.from_numpy(x).movedim(-1, 1).contiguous()       # channels on axis 1
    with torch.no_grad():
        plain = bn(xt)
    for t in (bn.running_mean, bn.running_var):
        t.requires_grad_(True)
    out = bn(xt)
    torch.testing.assert_close(out.detach(), plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.detach().movedim(1, -1).numpy(), want_out, rtol=1e-6,
                               atol=1e-6)
    (out * torch.from_numpy(w).movedim(-1, 1)).sum().backward()
    for tname, jname in (("weight", "scale"), ("bias", "bias"),
                         ("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, tname).grad.numpy(),
                                   np.asarray(want_grads[jname]), rtol=1e-5, atol=1e-6,
                                   err_msg=jname)
