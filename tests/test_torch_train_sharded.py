"""Training under a mesh through the port against the JAX package on the
CPU: the ViT classifier's tensor-parallel step
(``train/trainer.py::make_sharded_train_step``) and the triplet makers
(``make_sharded_triplet_step``, ``make_sharded_xbm_step``) with
``finetune_facenet(mesh=...)``. The YOLOv3 makers and loops are in
tests/test_torch_train_sharded_yolo.py.

A port mesh repeats the CPU (``make_mesh(..., devices=["cpu"] * n)``), as
the JAX package's tests shard over 8 virtual CPU devices: every shard and
every ``"model"`` block runs, one after another, on the one CPU.

- The classifier (img 32, patch 16, 5 classes, batch 8, lr 1e-3) on a
  ``(4 x 2)`` mesh, 3 steps from the same numpy-drawn tree: at dim 128
  depth 2 (2 heads, one per ``"model"`` device), with ``remat``, and at dim
  64 (one head, cut in two by the split). Each step's loss and accuracy
  against the jitted JAX ``train_step`` on one device, against JAX's own
  ``make_sharded_train_step`` on its 8 virtual devices, and against the
  port's unsharded ``train_step``; the gradients and the parameters after
  the first step, and every leaf after the last. The loss descends on the
  fixed batch (tests/test_parallel.py:52).
- The triplet makers on 4 shards of the JAX tests' ``TinyEnc`` and batch
  (tests/test_train_triplet.py:93, :171) against the JAX single-device
  steps, at those tests' tolerances: loss rtol 1e-5, embeddings rtol 1e-4
  atol 1e-6, leaves rtol 2e-4 atol 2e-6; the batch is split into 4 shard
  forwards; a batch the shards do not divide raises.
- ``finetune_facenet(mesh=...)`` with and without the bank, ``batch_size``
  6 on 4 shards (rounded to 8), against the JAX loop under a 4-device
  mesh: the history within rtol 1e-4.

Tolerances after one step: ``tests/torch_train_ref.py`` (the attention
key biases' gradient, 0 in exact arithmetic, within 1e-6 x the largest).
After three steps every leaf is within 1e-4 x max(|p|, |p before|) + 1e-2
x lr per step where each of the three JAX gradients is well above rounding
(``check_params``' rule: |g| > 1e-3 x the tensor's max and > 1e-5): a
later AdamW step divides the running mean of gradients that may cancel,
so its error is a share of lr, not of p; and within 2 x lr per step
elsewhere, where rounding decides the sign of AdamW's step (the worst
entry measured at 0.07 of its bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videotofaces_tpu.parallel import make_mesh as jax_make_mesh
from videotofaces_tpu.train import trainer as JTR
from videotofaces_tpu.train import triplet as JT
from videotofaces_tpu_torch.parallel import make_mesh
from videotofaces_tpu_torch.train import trainer as TTR
from videotofaces_tpu_torch.train import triplet as TT
from videotofaces_tpu_torch.train.optim import AdamW, leaves
from videotofaces_tpu_torch.utils.weights import flatten, state_dict_to_jax

from test_torch_facenet import few_threads  # noqa: F401
from test_torch_train_triplet import TinyEnc, class_images, tiny_twin
from torch_train_ref import (LOSS_RTOL, assert_grads_close, assert_params_after_step,
                             flat_np, port_params)

LR, CLASSES, STEPS = 1e-3, 5, 3
# (name, ViT width and depth, remat)
CASES = [("dim128", dict(dim=128, depth=2), False),
         ("dim128_remat", dict(dim=128, depth=2), True),
         ("dim64_head_split", dict(dim=64, depth=2), False)]
TRIPLET_TOL = dict(rtol=2e-4, atol=2e-6)
HIST_RTOL = 1e-4


def classifier_params(arch, seed=0):
    """``{"backbone", "head"}`` in the JAX layout, drawn with numpy
    (tests/test_torch_train_vit.py's recipe at this width)."""
    shapes = jax.eval_shape(JTR.ViTClassifier(CLASSES, img_size=32, patch_size=16, **arch).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
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


def _jax_steps(step, params, opt_state, images, labels, grads_of=None):
    out = []
    for _ in range(STEPS):
        rec = {}
        if grads_of is not None:
            rec["grads"] = flat_np(grads_of(params))
        params, opt_state, loss, acc = step(params, opt_state, images, labels)
        rec.update(loss=float(loss), acc=float(acc), params=flat_np(params))
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def vit_ref():
    """Per case: the JAX single-device steps (with each step's gradients)
    and JAX's sharded steps on a (4 x 2) mesh of its virtual devices."""
    rng = np.random.default_rng(1)
    images = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 8).astype(np.int32)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    out = dict(images=images, labels=labels)
    for name, arch, remat in CASES:
        params = classifier_params(arch)
        model = JTR.ViTClassifier(CLASSES, img_size=32, patch_size=16, remat=remat, **arch)
        tx = optax.adamw(LR, weight_decay=1e-4)
        single = jax.jit(lambda p, o, a, b, m=model, t=tx: JTR.train_step(p, o, a, b, m, t))
        grads = jax.jit(lambda p, m=model: jax.grad(
            lambda q: JTR.loss_fn(q, m, x, y)[0])(p))
        rec = dict(params=params, single=_jax_steps(single, params, tx.init(params), x, y,
                                                    grads))
        mesh = jax_make_mesh(4, 2, jax.devices())
        step, sp, so = JTR.make_sharded_train_step(mesh, model, tx, params, tx.init(params))
        with mesh:
            rec["sharded"] = _jax_steps(step, sp, so, x, y)
        out[name] = rec
    return out


def _port_runs(ref, name, arch, remat):
    """The port's TP step on a (4 x 2) CPU mesh and its single-device step,
    3 steps each: [(loss, acc, flat JAX-layout params)] per step, and the
    TP step's gradients of the first step."""
    x = torch.from_numpy(ref["images"]).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(ref["labels"])
    params = ref[name]["params"]
    kw = dict(img_size=32, patch_size=16, remat=remat, **arch)
    model = TTR.ViTClassifier.from_jax(params, CLASSES, **kw)
    opt = TTR.create_train_state(model, LR)
    mesh = make_mesh(4, 2, ["cpu"] * 8)
    step, _, opt = TTR.make_sharded_train_step(mesh, model, opt)
    single = TTR.ViTClassifier.from_jax(params, CLASSES, **kw)
    single_opt = TTR.create_train_state(single, LR)
    tp, one, grads = [], [], None
    for i in range(STEPS):
        loss, acc = step(x, y)
        tp.append((float(loss), float(acc), flatten(state_dict_to_jax(step.state_dict()))))
        if i == 0:
            grads = _gathered_grads(model, opt, mesh)
        loss, acc = TTR.train_step(single, single_opt, x, y)
        one.append((float(loss), float(acc), port_params(single)))
    return tp, one, grads


def _gathered_grads(model, opt, mesh):
    """The first step's gradients of the TP step's master blocks, joined
    back into whole leaves (flat, JAX layout)."""
    dims = TTR._split_dims(model, mesh)
    it = iter(opt.leaves)
    sd = {}
    for k, _ in leaves(model):
        n = 1 if dims[k] is None else len(mesh.grid[0])
        blocks = [next(it).grad for _ in range(n)]
        sd[k] = blocks[0] if n == 1 else torch.cat(blocks, dims[k])
    return flatten(state_dict_to_jax(sd))


def _noisy(grads):
    """Per leaf: where a gradient lies within rounding of 0 (``check_params``'
    rule), at any of the steps."""
    out = {}
    for g in grads:
        for k, v in g.items():
            a = np.abs(v)
            small = (a <= 1e-3 * a.max()) | (a <= 1e-5)
            out[k] = small | out.get(k, False)
    return out


def assert_leaves_after_steps(got, want, before, noisy, lr=LR, steps=STEPS):
    assert set(got) == set(want)
    for k in want:
        err = np.abs(got[k] - want[k])
        bound = np.where(noisy[k], 2 * lr * steps,
                         1e-4 * np.maximum(np.abs(want[k]), np.abs(before[k]))
                         + 1e-2 * lr * steps)
        assert (err <= bound).all(), (k, float((err / bound).max()))


@pytest.mark.parametrize("name,arch,remat", CASES, ids=[c[0] for c in CASES])
def test_tp_step_matches_jax(vit_ref, name, arch, remat):
    ref = vit_ref[name]
    tp, one, grads = _port_runs(vit_ref, name, arch, remat)
    before = flat_np(ref["params"])
    for i in range(STEPS):
        for other in (ref["single"][i], ref["sharded"][i]):
            np.testing.assert_allclose(tp[i][0], other["loss"], rtol=LOSS_RTOL, err_msg=i)
            assert tp[i][1] == other["acc"], i
        np.testing.assert_allclose(tp[i][0], one[i][0], rtol=LOSS_RTOL, err_msg=i)
        assert tp[i][1] == one[i][1]
    # the first step: gradients, then the parameters
    want = ref["single"][0]["grads"]
    zero = {k for k in want if k.endswith("attn/k/bias")}
    top = max(np.abs(g).max() for g in want.values())
    for k in zero:
        assert max(np.abs(grads[k]).max(), np.abs(want[k]).max()) <= 1e-6 * top, k
    assert_grads_close({k: v for k, v in grads.items() if k not in zero},
                       {k: v for k, v in want.items() if k not in zero})
    assert_params_after_step(tp[0][2], ref["single"][0]["params"], before, want, LR)
    # every leaf after the last step
    noisy = _noisy([r["grads"] for r in ref["single"]])
    for other in (ref["single"][-1]["params"], ref["sharded"][-1]["params"], one[-1][2]):
        assert_leaves_after_steps(tp[-1][2], other, before, noisy)
    # the JAX test's check: it optimizes on a fixed batch
    assert np.isfinite([t[0] for t in tp]).all() and tp[2][0] < tp[0][0]


def test_tp_step_places_the_blocks_and_raises_on_a_ragged_batch():
    """On a (2 x 2) mesh: AdamW updates one block per "model" column of each
    split leaf (its mu / nu with it) and the replicated leaves once; a batch
    the 2 data shards do not divide raises; a model that is not the
    optimizer's raises."""
    arch = dict(img_size=32, patch_size=16, dim=128, depth=1)
    model = TTR.ViTClassifier.seeded(CLASSES, seed=2, **arch)
    opt = TTR.create_train_state(model, LR)
    n_leaves = len(opt.leaves)
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    step, same, opt = TTR.make_sharded_train_step(mesh, model, opt)
    assert same is model
    # 10 leaves per block split in two: q/k/v/fc1 weights and biases, proj and fc2 weights
    assert len(opt.leaves) == n_leaves + 10
    assert all(m.shape == t.shape for m, t in zip(opt.mu, opt.leaves))
    x, y = torch.randn(6, 3, 32, 32), torch.arange(6) % CLASSES
    loss, _ = step(x[:4], y[:4])
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="does not split over 2 data shards"):
        step(x[:5], y[:5])
    other = TTR.ViTClassifier.seeded(CLASSES, seed=3, **arch)
    with pytest.raises(ValueError, match="not the model's"):
        TTR.make_sharded_train_step(mesh, other, TTR.create_train_state(model, LR))


# -- the triplet makers and the loop -----------------------------------------------


@pytest.fixture(scope="module")
def triplet_ref():
    """tests/test_train_triplet.py:93 and :171: TinyEnc, batch 12 of three
    classes, one jitted single-device step each."""
    rng = np.random.default_rng(0)
    model = TinyEnc()
    out = {}
    for kind, key in (("plain", 1), ("xbm", 4)):
        params, opt_state, tx = JT.create_train_state(model, jax.random.PRNGKey(key),
                                                      (1, 12, 12, 3), learning_rate=1e-3)
        xs, ys = class_images(rng, n_per_class=4)
        rec = dict(params=jax.tree.map(np.asarray, params), xs=xs, ys=ys)
        x, y = jnp.asarray(xs), jnp.asarray(ys)
        if kind == "plain":
            p, _, loss, act = jax.jit(lambda p, o, a, b: JT.train_step(p, o, a, b, model, tx))(
                params, opt_state, x, y)
        else:
            bank = JT.MemoryBank(8, 8)
            bank.push(rng.normal(size=(5, 8)).astype(np.float32), [9, 9, 8, 8, 7])
            rec["bank"] = [np.asarray(a) for a in bank.arrays()]
            be, bl, bv = bank.arrays()
            p, _, loss, act, emb = jax.jit(lambda p, o, a, b: JT.train_step_xbm(
                p, o, a, b, be, bl, bv, model, tx))(params, opt_state, x, y)
            rec["emb"] = np.asarray(emb)
        rec.update(new=flat_np(p), loss=float(loss), act=float(act))
        out[kind] = rec
    xl, yl = class_images(np.random.default_rng(1), n_per_class=6, size=16)
    xl_u8 = np.clip((xl + 2) * 50, 0, 255).astype(np.uint8)
    out["loops"] = dict(images=xl_u8, labels=yl)
    mesh = jax_make_mesh(n_data=4, devices=jax.devices()[:4])
    for bank_size in (0, 12):
        init = TinyEnc().init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)))["params"]
        out["loops"]["params"] = jax.tree.map(np.asarray, init)
        _, out["loops"][bank_size] = JT.finetune_facenet(
            xl_u8, yl, epochs=2, batch_size=6, learning_rate=1e-3, model=TinyEnc(),
            params=init, bank_size=bank_size, seed=4, mesh=mesh)
    return out


@pytest.mark.parametrize("kind", ["plain", "xbm"])
def test_sharded_triplet_makers_match_jax(triplet_ref, kind):
    r = triplet_ref[kind]
    model = tiny_twin(r["params"])
    opt = AdamW(leaves(model), 1e-3)
    mesh = make_mesh(devices=["cpu"] * 4)
    maker = TT.make_sharded_triplet_step if kind == "plain" else TT.make_sharded_xbm_step
    step, model, opt = maker(mesh, model, opt)
    seen = []
    model.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    x = torch.from_numpy(r["xs"]).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(r["ys"])
    if kind == "plain":
        loss, act = step(x, y)
    else:
        loss, act, emb = step(x, y, *(torch.from_numpy(a) for a in r["bank"]))
        np.testing.assert_allclose(emb.numpy(), r["emb"], rtol=1e-4, atol=1e-6)
    assert seen == [3, 3, 3, 3]                     # four shards, not one device
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(act), r["act"], rtol=1e-5)
    got = port_params(model)
    assert set(got) == set(r["new"])
    for k in r["new"]:
        np.testing.assert_allclose(got[k], r["new"][k], err_msg=k, **TRIPLET_TOL)
    with pytest.raises(ValueError, match="does not split over 4 data shards"):
        step(x[:10], y[:10], *(() if kind == "plain" else
                               (torch.from_numpy(a) for a in r["bank"])))


@pytest.mark.parametrize("bank_size", [0, 12], ids=["no_bank", "bank12"])
def test_finetune_facenet_with_a_mesh_matches_jax(triplet_ref, bank_size):
    r = triplet_ref["loops"]
    tree, hist = TT.finetune_facenet(r["images"], r["labels"], epochs=2, batch_size=6,
                                     learning_rate=1e-3, model=tiny_twin(r["params"]),
                                     bank_size=bank_size, seed=4,
                                     mesh=make_mesh(devices=["cpu"] * 4))
    # 18 crops, batch 6 rounded to 8 on 4 shards: two steps per epoch
    assert len(hist) == 2
    np.testing.assert_allclose(hist, r[bank_size], rtol=HIST_RTOL)
    assert set(flat_np(tree)) == set(flat_np(r["params"]))
