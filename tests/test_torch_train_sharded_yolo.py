"""The YOLOv3 step makers under a mesh through the port
(``train/detector.py::make_sharded_head_step`` / ``make_sharded_full_step``
and the loops' ``mesh=``) against the JAX package on the CPU, at 64 px:

- each maker on 4 shards of a repeated CPU mesh against the JAX
  single-device step, as tests/test_train_detector.py:162 and :192 hold
  JAX's own makers (its params ``YOLOv3(1).init(PRNGKey(1))``, its 4
  frames, ``layerwise_tx(1e-3)`` for the full step and ``optax.adamw(1e-3)``
  over the head for the head step) at their tolerances: loss rtol 1e-4,
  every leaf atol 1e-4; the full step's clip sees the global norm of the
  whole batch's gradients (rtol 1e-4); the trunk of the head step stays as
  it was; a batch the shards do not divide raises;
- ``finetune_yolo_head`` / ``finetune_yolo_full`` with ``mesh=``,
  ``batch_size`` 6 on 4 shards (rounded to 8), 8 frames, 2 epochs, against
  the JAX loops under a 4-device mesh: the history within rtol 1e-4, and
  the returned tree loads into the port's ``YoloDetector``.

One module-scoped JAX reference."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotofaces_tpu.models import yolo as JY
from videotofaces_tpu.parallel import make_mesh as jax_make_mesh
from videotofaces_tpu.train import detector as JTD
from videotofaces_tpu_torch.models import yolo as TY
from videotofaces_tpu_torch.models.wrappers import YoloDetector
from videotofaces_tpu_torch.parallel import make_mesh
from videotofaces_tpu_torch.train import detector as TD
from videotofaces_tpu_torch.train.optim import AdamW, leaves

from test_torch_facenet import few_threads  # noqa: F401
from test_torch_train_detector import synthetic_faces
from test_torch_yolo import jax_yolo_params
from torch_train_ref import flat_np, port_params

LR = 1e-3
LOSS_RTOL, LEAF_ATOL, HIST_RTOL = 1e-4, 1e-4, 1e-4


@pytest.fixture(scope="module")
def ref():
    frames, gts = synthetic_faces(np.random.default_rng(0), 4)
    priors, strides = JY.flat_priors_and_strides((64, 64))
    canvas = frames[..., ::-1].astype(np.float32) / 255.0
    obj_t, box_t = JTD.assign_batch(list(gts), priors)
    params = jax.tree.map(np.asarray, jax.jit(JY.YOLOv3(1).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"])
    pr, st = jnp.asarray(priors), jnp.asarray(strides)
    batch = [jnp.asarray(a) for a in (canvas, obj_t, box_t)]
    out = dict(params=params, canvas=canvas, obj_t=obj_t, box_t=box_t, priors=priors,
               strides=strides)
    tx = JTD.layerwise_tx(LR)
    p1, _, loss, _ = jax.jit(lambda pp, oo, x, ot, bt: JTD.train_step_full(
        pp, oo, x, ot, bt, pr, st, tx))(params, tx.init(params), *batch)
    grads = jax.jit(jax.grad(lambda pp: JTD.detection_loss_full(pp, *batch, pr, st)[0]))(params)
    out["full"] = dict(loss=float(loss), new=flat_np(p1), norm=float(optax.global_norm(grads)))
    trunk = {k: v for k, v in params.items() if k != "head"}
    tx = optax.adamw(LR)
    h1, _, loss, _ = jax.jit(lambda hh, oo, x, ot, bt: JTD.train_step(
        hh, oo, trunk, x, ot, bt, pr, st, tx))(params["head"], tx.init(params["head"]), *batch)
    out["head"] = dict(loss=float(loss), new=flat_np(h1))

    frames8, gts8 = synthetic_faces(np.random.default_rng(1), 8)
    lparams = jax_yolo_params(0)
    mesh = jax_make_mesh(n_data=4, devices=jax.devices()[:4])
    out["loops"] = dict(frames=frames8, gts=gts8, params=lparams)
    for name, fn in (("head", JTD.finetune_yolo_head), ("full", JTD.finetune_yolo_full)):
        tree, hist = fn(frames8, gts8, epochs=2, batch_size=6, learning_rate=LR, max_side=64,
                        params=lparams, seed=0, mesh=mesh)
        out["loops"][name] = dict(hist=hist, keys={k: v.shape for k, v in flat_np(tree).items()})
    return out


@pytest.mark.parametrize("kind", ["head", "full"])
def test_sharded_yolo_makers_match_jax(ref, kind):
    model = TY.YOLOv3.from_jax(ref["params"])
    if kind == "head":
        opt = AdamW(leaves(model.head), LR)
        step, model, opt = TD.make_sharded_head_step(make_mesh(devices=["cpu"] * 4), opt, model,
                                                     ref["priors"], ref["strides"])
    else:
        opt = TD.layerwise_tx(model, LR)
        step, model, opt = TD.make_sharded_full_step(make_mesh(devices=["cpu"] * 4), opt, model,
                                                     ref["priors"], ref["strides"])
    seen = []
    model.head.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    x = torch.from_numpy(ref["canvas"]).permute(0, 3, 1, 2).contiguous()
    obj_t, box_t = torch.from_numpy(ref["obj_t"]), torch.from_numpy(ref["box_t"])
    loss, aux = step(x, obj_t, box_t)
    assert seen == [1, 1, 1, 1] and set(aux) == {"obj", "cls", "box"}
    want = ref[kind]
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    got = port_params(model)
    if kind == "head":
        base = flat_np(ref["params"])
        for k in base:
            if not k.startswith("head/"):
                np.testing.assert_array_equal(got[k], base[k], err_msg=k)
        got = {k[len("head/"):]: v for k, v in got.items() if k.startswith("head/")}
    else:
        np.testing.assert_allclose(float(opt.grad_norm), want["norm"], rtol=1e-4)
    assert set(got) == set(want["new"])
    for k in want["new"]:
        np.testing.assert_allclose(got[k], want["new"][k], rtol=0, atol=LEAF_ATOL, err_msg=k)
    with pytest.raises(ValueError, match="does not split over 4 data shards"):
        step(x[:3], obj_t[:3], box_t[:3])


@pytest.mark.parametrize("kind", ["head", "full"])
def test_yolo_loops_with_a_mesh_match_jax(ref, kind):
    r = ref["loops"]
    fn = TD.finetune_yolo_head if kind == "head" else TD.finetune_yolo_full
    tree, hist = fn(r["frames"], r["gts"], epochs=2, batch_size=6, learning_rate=LR,
                    max_side=64, params=r["params"], seed=0,
                    mesh=make_mesh(devices=["cpu"] * 4))
    assert len(hist) == 2                     # 8 frames, batch 6 rounded to 8: one step an epoch
    np.testing.assert_allclose(hist, r[kind]["hist"], rtol=HIST_RTOL)
    got = flat_np(tree)
    assert {k: v.shape for k, v in got.items()} == r[kind]["keys"]
    boxes, scores, _ = YoloDetector(device="cpu", params=tree, max_side=64)(list(r["frames"][:2]))
    assert len(boxes) == 2 and all(np.isfinite(s).all() for s in scores)
