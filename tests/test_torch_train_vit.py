"""The ViT classifier step through the port (``videotofaces_tpu_torch/train/
trainer.py``) against the JAX package's ``train/trainer.py`` on the CPU, from
the same numpy-drawn ``{"backbone", "head"}`` tree at img 32, patch 16, dim
64, depth 2, 5 classes: one ``train_step`` with ``create_train_state``'s
AdamW (lr 1e-3 here, weight decay 1e-4), with and without ``remat`` on
both sides — the loss, the accuracy, every gradient and the updated
parameters; ``remat`` leaves the step's results as they are; a few steps
on a fixed batch lower the loss.

Tolerances: ``tests/torch_train_ref.py``; the accuracy exact; remat
against no remat on the port: equal to float rounding (rtol 1e-6, atol
1e-7 x max|g|). The attention key biases' gradient is 0 in exact
arithmetic (a softmax ignores a shift shared by a query's logits), so both
sides hold rounding noise there: each is held to 1e-6 x the largest
gradient of the tree instead. One module-scoped JAX reference."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotofaces_tpu.train import trainer as JTR
from videotofaces_tpu_torch.train import trainer as TTR
from videotofaces_tpu_torch.train.optim import leaves

from test_torch_facenet import few_threads  # noqa: F401
from torch_train_ref import (LOSS_RTOL, assert_grads_close, assert_params_after_step,
                             flat_np, jax_update, port_grads, port_params)

ARCH = dict(img_size=32, patch_size=16, dim=64, depth=2)
CLASSES, LR = 5, 1e-3


def jax_classifier_params(seed=0):
    """``{"backbone", "head"}`` in the JAX layout, drawn with numpy: dense
    and patch kernels N(0, 1/fan_in), biases N(0, 0.02), LayerNorm scale
    1 + N(0, 0.1) and bias N(0, 0.1), class token N(0, 0.5), positional
    embedding N(0, 0.1) (``tests/test_torch_vit.py``'s recipe)."""
    shapes = jax.eval_shape(JTR.ViTClassifier(CLASSES, **ARCH).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
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
def ref():
    params = jax_classifier_params(0)
    rng = np.random.default_rng(1)
    images = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 8).astype(np.int32)
    out = dict(params=params, images=images, labels=labels)
    for remat in (False, True):
        model = JTR.ViTClassifier(CLASSES, remat=remat, **ARCH)
        (loss, acc), grads = jax.jit(jax.value_and_grad(
            lambda p, x, y, m=model: JTR.loss_fn(p, m, x, y), has_aux=True))(
            params, jnp.asarray(images), jnp.asarray(labels))
        tx = optax.adamw(LR, weight_decay=1e-4)      # create_train_state's
        out[remat] = dict(loss=float(loss), acc=float(acc), grads=flat_np(grads),
                          new=flat_np(jax_update(tx, grads, params)))
    return out


def _port_step(ref, remat):
    model = TTR.ViTClassifier.from_jax(ref["params"], CLASSES, remat=remat, **ARCH)
    opt = TTR.create_train_state(model, learning_rate=LR)
    x = torch.from_numpy(ref["images"]).permute(0, 3, 1, 2).contiguous()
    loss, acc = TTR.train_step(model, opt, x, torch.from_numpy(ref["labels"]))
    return model, loss, acc


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_classifier_step_matches_jax(ref, remat):
    model, loss, acc = _port_step(ref, remat)
    want = ref[remat]
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    assert float(acc) == want["acc"]
    got, top = port_grads(model), max(np.abs(g).max() for g in want["grads"].values())
    zero = {k for k in want["grads"] if k.endswith("attn/k/bias")}
    assert len(zero) == ARCH["depth"]
    for k in zero:
        assert max(np.abs(got[k]).max(), np.abs(want["grads"][k]).max()) <= 1e-6 * top, k
    assert_grads_close({k: v for k, v in got.items() if k not in zero},
                       {k: v for k, v in want["grads"].items() if k not in zero})
    assert_params_after_step(port_params(model), want["new"], flat_np(ref["params"]),
                             want["grads"], LR)


def test_remat_changes_nothing(ref):
    (m0, l0, a0), (m1, l1, a1) = _port_step(ref, False), _port_step(ref, True)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    assert float(a1) == float(a0)
    g0, g1 = port_grads(m0), port_grads(m1)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-7 * np.abs(g0[k]).max(),
                                   err_msg=k)


def test_classifier_layout_and_seeded():
    model = TTR.ViTClassifier.seeded(CLASSES, seed=3, **ARCH)
    assert model.head.weight.shape == (CLASSES, 64)
    names = {k for k, _ in leaves(model)}
    assert {"head.weight", "head.bias", "backbone.class_token"} <= names
    again = TTR.ViTClassifier.seeded(CLASSES, seed=3, **ARCH)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_classifier_steps_descend_on_a_fixed_batch(ref):
    model = TTR.ViTClassifier.from_jax(ref["params"], CLASSES, **ARCH)
    opt = TTR.create_train_state(model, learning_rate=LR)
    x = torch.from_numpy(ref["images"]).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(ref["labels"])
    losses = [float(TTR.train_step(model, opt, x, y)[0]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[2] < losses[0], losses
