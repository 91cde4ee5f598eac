"""YOLOv3 fine-tuning through the port (``videotofaces_tpu_torch/train/
detector.py``) against the JAX package's ``train/detector.py``, both on the
CPU from the same numpy-seeded parameters (``jax_yolo_params``) at full
width, 64 px frames with one bright block each:

- the host helpers (target assignment, the /255 canvas) equal;
- one head-only step and one full step (``layerwise_tx``, global norm above
  ``clip_norm``, and again with ``{"backbone": 0.0}``): the loss and its
  three parts, every gradient (BatchNorm statistics included), the clip's
  global norm and the updated parameters;
- ``finetune_yolo_head`` and ``finetune_yolo_full`` for 2 epochs: the
  history, and the returned tree loads into the port's ``YoloDetector``;
- the JAX package's single-device descent tests, on the port.

Tolerances: ``tests/torch_train_ref.py``; histories rtol 1e-4 (four steps
compound the one-step differences). One module-scoped JAX reference."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotofaces_tpu.models import yolo as JY
from videotofaces_tpu.train import detector as JTD
from videotofaces_tpu_torch.models import yolo as TY
from videotofaces_tpu_torch.models.wrappers import YoloDetector
from videotofaces_tpu_torch.train import detector as TD
from videotofaces_tpu_torch.train.optim import leaves

from test_torch_facenet import few_threads  # noqa: F401
from test_torch_yolo import jax_yolo_params
from torch_train_ref import (GRAD_RTOL, LOSS_RTOL, assert_grads_close, assert_params_after_step,
                             flat_np, jax_update, port_grads, port_params)

LR = 1e-3
HIST_RTOL = 1e-4


def synthetic_faces(rng, n, size=64):
    """Frames with one bright block each; gt = the block's box (the JAX
    package's tests/test_train_detector.py recipe)."""
    frames, gts = [], []
    for _ in range(n):
        f = (rng.random((size, size, 3)) * 60).astype(np.uint8)
        x = int(rng.integers(4, size - 28))
        y = int(rng.integers(4, size - 28))
        s = int(rng.integers(16, 26))
        f[y:y + s, x:x + s] = (210, 180, 160)
        frames.append(f)
        gts.append(np.asarray([[x, y, x + s, y + s]], np.float32))
    return np.stack(frames), gts


def _bn_stat(key):
    parts = key.split("/")
    return "bn" in parts and parts[-1] in ("mean", "var")


def _layer_scale(scales):
    merged = {"backbone": 0.1, "neck": 0.3, "head": 1.0, **scales}
    return lambda k: 0.0 if _bn_stat(k) else merged[k.split("/")[0]]


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: one step's loss, aux, gradients and updates for
    the head-only and full paths, and the histories of both loops."""
    params = jax_yolo_params(0)
    frames, gts = synthetic_faces(np.random.default_rng(0), 4)
    priors, strides = JY.flat_priors_and_strides((64, 64))
    canvas = frames[..., ::-1].astype(np.float32) / 255.0
    obj_t, box_t = JTD.assign_batch(gts, priors)
    args = (jnp.asarray(canvas), jnp.asarray(obj_t), jnp.asarray(box_t),
            jnp.asarray(priors), jnp.asarray(strides))
    out = dict(params=params, frames=frames, gts=gts, canvas=canvas, obj_t=obj_t,
               box_t=box_t, priors=priors, strides=strides)

    (loss, aux), grads = jax.jit(jax.value_and_grad(JTD.detection_loss_full, has_aux=True))(
        params, *args)
    out["full"] = dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                       grads=flat_np(grads), norm=float(optax.global_norm(grads)),
                       norm_without_stats=float(optax.global_norm(
                           {k: v for k, v in flat_np(grads).items() if not _bn_stat(k)})))
    for name, scales in (("default", None), ("backbone0", {"backbone": 0.0})):
        out["full"][name] = flat_np(jax_update(JTD.layerwise_tx(LR, scales), grads, params))

    trunk = {k: v for k, v in params.items() if k != "head"}
    (loss, aux), grads = jax.jit(jax.value_and_grad(JTD.detection_loss, has_aux=True))(
        params["head"], trunk, *args)
    out["head"] = dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                       grads=flat_np(grads),
                       new=flat_np(jax_update(JTD.bn_stats_frozen(optax.adamw(LR)), grads,
                                              params["head"])))

    loop = dict(epochs=2, batch_size=2, learning_rate=LR, max_side=64, params=params, seed=0)
    for name, fn in (("head_loop", JTD.finetune_yolo_head), ("full_loop", JTD.finetune_yolo_full)):
        tree, hist = fn(frames, gts, **loop)
        out[name] = dict(hist=hist, keys={k: v.shape for k, v in flat_np(tree).items()})
    return out


def _port_step(ref, path, scales=None):
    model = TY.YOLOv3.from_jax(ref["params"])
    if path == "head":
        opt = TD.bn_stats_frozen(leaves(model.head), LR)
        step = TD.train_step
    else:
        opt = TD.layerwise_tx(model, LR, scales)
        step = TD.train_step_full
    tensors = [torch.from_numpy(ref[k]) for k in ("obj_t", "box_t", "priors", "strides")]
    x = torch.from_numpy(ref["canvas"]).permute(0, 3, 1, 2).contiguous()
    loss, aux = step(model, opt, x, *tensors)
    return model, opt, loss, aux


def _assert_loss(loss, aux, want):
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    assert set(aux) == {"obj", "cls", "box"}
    for k, v in want["aux"].items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=LOSS_RTOL, err_msg=k)


def test_host_helpers_match_jax():
    frames, gts = synthetic_faces(np.random.default_rng(1), 3, size=80)
    priors, _ = TY.flat_priors_and_strides((64, 64))
    for a, b in zip(TD._prepare_yolo_data(frames, gts, priors, 0.5, 0.4, 64, 64, 64, 64),
                    JTD._prepare_yolo_data(frames, gts, priors, 0.5, 0.4, 64, 64, 64, 64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TD.iou_matrix(priors[:50], priors[20:90]),
                                  JTD.iou_matrix(priors[:50], priors[20:90]))


def test_head_step_matches_jax(ref):
    model, _, loss, aux = _port_step(ref, "head")
    want = ref["head"]
    _assert_loss(loss, aux, want)
    assert_grads_close(port_grads(model.head), want["grads"])
    got = port_params(model)
    assert_params_after_step({k[5:]: v for k, v in got.items() if k.startswith("head/")},
                             want["new"], flat_np(ref["params"]["head"]), want["grads"], LR,
                             lambda k: 0.0 if _bn_stat(k) else 1.0)
    # the trunk is held constant: no gradient, no update
    base = flat_np(ref["params"])
    for k in base:
        if not k.startswith("head/"):
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)
    assert all(t.grad is None for _, t in leaves(model.backbone))


@pytest.mark.parametrize("scales", [None, {"backbone": 0.0}], ids=["default", "backbone0"])
def test_full_step_matches_jax(ref, scales):
    model, opt, loss, aux = _port_step(ref, "full", scales)
    want = ref["full"]
    _assert_loss(loss, aux, want)
    # the clip counts every gradient, BatchNorm statistics included: without
    # them the norm would differ by more than the tolerance
    assert want["norm"] > 1.0
    assert abs(want["norm"] - want["norm_without_stats"]) > 1e-3 * want["norm"]
    np.testing.assert_allclose(float(opt.grad_norm), want["norm"], rtol=GRAD_RTOL)
    # .grad holds the clipped gradients: g * max_norm / norm
    assert_grads_close(port_grads(model), {k: g / np.float32(want["norm"])
                                           for k, g in want["grads"].items()})
    name = "default" if scales is None else "backbone0"
    assert_params_after_step(port_params(model), want[name], flat_np(ref["params"]),
                             want["grads"], LR,
                             _layer_scale(scales or {}))


@pytest.mark.parametrize("kind", ["head_loop", "full_loop"])
def test_finetune_loops_match_jax(ref, kind):
    fn = TD.finetune_yolo_head if kind == "head_loop" else TD.finetune_yolo_full
    tree, hist = fn(ref["frames"], ref["gts"], epochs=2, batch_size=2, learning_rate=LR,
                    max_side=64, params=ref["params"], seed=0, device="cpu")
    np.testing.assert_allclose(hist, ref[kind]["hist"], rtol=HIST_RTOL)
    got = flat_np(tree)
    assert {k: v.shape for k, v in got.items()} == ref[kind]["keys"]
    assert all(v.dtype == np.float32 for v in got.values())
    det = YoloDetector(device="cpu", params=tree, max_side=64)
    boxes, scores, _ = det(list(ref["frames"][:2]))
    assert len(boxes) == 2 and all(np.isfinite(s).all() for s in scores)


def test_loss_refuses_multiclass(ref):
    with pytest.raises(ValueError, match="num_classes=1 only"):
        TD.detection_loss_full(None, None, None, None, None, None, num_classes=2)


def test_device_none_means_cuda(monkeypatch, ref):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TD.finetune_yolo_head(ref["frames"], ref["gts"], max_side=64, params=ref["params"])


# -- the JAX package's single-device tests, on the port ------------------------


def test_iou_matrix_basics():
    a = np.asarray([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
    b = np.asarray([[0, 0, 10, 10], [5, 5, 15, 15]], np.float32)
    m = TD.iou_matrix(a, b)
    np.testing.assert_allclose(m[0, 0], 1.0)
    np.testing.assert_allclose(m[0, 1], 25.0 / 175.0, rtol=1e-6)
    np.testing.assert_allclose(m[1, 0], 0.0)


def test_assign_targets_pos_neg_forced():
    priors, _ = TY.flat_priors_and_strides((64, 64))
    corners = TD.priors_to_corners(priors)
    gt = corners[7:8].copy()
    obj_t, box_t = TD.assign_targets(gt, priors)
    assert obj_t[7] == 1.0
    np.testing.assert_allclose(box_t[7], gt[0])
    tiny = np.asarray([[30.0, 30.0, 33.0, 33.0]], np.float32)
    obj_t2, box_t2 = TD.assign_targets(tiny, priors)
    assert (obj_t2 == 1.0).sum() >= 1
    got = box_t2[obj_t2 == 1.0]
    np.testing.assert_allclose(got, np.repeat(tiny, got.shape[0], axis=0))
    obj_t3, _ = TD.assign_targets(np.zeros((0, 4)), priors)
    assert (obj_t3 == 0.0).all()


def test_giou_values():
    a = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    np.testing.assert_allclose(TD.giou(a, a).numpy(), [1.0], atol=1e-6)
    b = torch.tensor([[10.0, 0.0, 20.0, 10.0]])
    np.testing.assert_allclose(TD.giou(a, b).numpy(), [0.0], atol=1e-6)
    c = torch.tensor([[1000.0, 0.0, 1010.0, 10.0]])
    assert float(TD.giou(a, c)[0]) < -0.9
    # and the JAX package's on random boxes
    rng = np.random.default_rng(4)
    lt = rng.uniform(0, 50, (64, 2))
    p = np.concatenate([lt, lt + rng.uniform(1, 40, (64, 2))], 1).astype(np.float32)
    lt = rng.uniform(0, 50, (64, 2))
    g = np.concatenate([lt, lt + rng.uniform(1, 40, (64, 2))], 1).astype(np.float32)
    np.testing.assert_allclose(TD.giou(torch.from_numpy(p), torch.from_numpy(g)).numpy(),
                               np.asarray(JTD.giou(jnp.asarray(p), jnp.asarray(g))),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def flax_init():
    """The JAX tests' parameters: flax's own initializers at seed 0."""
    return jax.tree.map(np.asarray, jax.jit(JY.YOLOv3(1).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"])


def test_head_finetune_descends_and_freezes_trunk(flax_init):
    frames, gts = synthetic_faces(np.random.default_rng(0), 8)
    out, hist = TD.finetune_yolo_head(frames, gts, epochs=10, batch_size=4,
                                      learning_rate=3e-3, max_side=64,
                                      params=flax_init, seed=0, device="cpu")
    assert min(hist) < hist[0] * 0.7 and hist[-1] < hist[0], hist
    before, after = flat_np(flax_init), flat_np(out)
    for k in before:
        if not k.startswith("head/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert any(not np.allclose(after[k], before[k]) for k in before if k.startswith("head/"))


def test_full_finetune_layerwise(flax_init):
    frames, gts = synthetic_faces(np.random.default_rng(0), 8)
    out, hist = TD.finetune_yolo_full(frames, gts, epochs=6, batch_size=4,
                                      learning_rate=1e-3, max_side=64,
                                      params=flax_init, seed=0, device="cpu")
    assert hist[-1] < hist[0], hist
    before, after = flat_np(flax_init), flat_np(out)

    def max_delta(mod):
        return max(np.abs(after[k] - before[k]).max() for k in before if k.startswith(mod))

    assert max_delta("backbone/") > 0.0
    assert max_delta("neck/") > 0.0
    assert max_delta("head/") > 2.0 * max_delta("backbone/")
    out2, _ = TD.finetune_yolo_full(frames, gts, epochs=1, batch_size=4, learning_rate=1e-3,
                                    max_side=64, params=flax_init, seed=0, device="cpu",
                                    trunk_scales={"backbone": 0.0, "neck": 0.3, "head": 1.0})
    after2 = flat_np(out2)
    for k in before:
        if k.startswith("backbone/"):
            np.testing.assert_array_equal(after2[k], before[k], err_msg=k)


def test_partial_trunk_scales_merge_and_head_bn_stats_frozen(flax_init):
    frames, gts = synthetic_faces(np.random.default_rng(0), 4)
    out, _ = TD.finetune_yolo_full(frames, gts, epochs=1, batch_size=4, learning_rate=1e-3,
                                   max_side=64, params=flax_init, seed=0, device="cpu",
                                   trunk_scales={"backbone": 0.0})
    before, after = flat_np(flax_init), flat_np(out)
    for k in before:
        if k.startswith("backbone/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert any(not np.allclose(after[k], before[k]) for k in before if k.startswith("head/"))
    out2, _ = TD.finetune_yolo_head(frames, gts, epochs=1, batch_size=4, learning_rate=3e-3,
                                    max_side=64, params=flax_init, seed=0, device="cpu")
    after2 = flat_np(out2)
    stats = [k for k in before if k.startswith("head/") and _bn_stat(k)]
    assert stats, "the head should hold BatchNorm statistics"
    for k in stats:
        np.testing.assert_array_equal(after2[k], before[k], err_msg=k)
