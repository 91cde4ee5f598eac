"""Triplet fine-tuning through the port (``videotofaces_tpu_torch/train/
triplet.py``) against the JAX package's ``train/triplet.py``, both on the
CPU from the same numpy-drawn parameters:

- batch-hard mining, its memory-bank variant and ``MemoryBank``: masks
  exact, squared distances of unit embeddings within 1e-6;
- one ``train_step`` / ``train_step_xbm`` on the JAX tests' ``TinyEnc``
  (a torch twin built from the same parameters) and one full-width FaceNet
  step at 75 px, the smallest input its stride chain takes: the loss, the
  active fraction, every gradient (FaceNet's BatchNorm statistics
  included) and the updated parameters (the statistics included: the JAX
  loop's ``optax.adamw`` trains them);
- ``finetune_facenet`` for 2 epochs, FaceNet and ``TinyEnc`` with and
  without the bank: the history, and FaceNet's tree loads into the port's
  ``FaceNetEncoder``;
- the JAX package's single-device tests, on the port.

Tolerances: ``tests/torch_train_ref.py``; the active fraction exact;
histories rtol 1e-4; FaceNet's gradients atol 1e-4 x max|g_jax| per tensor:
through its 130 layers each side's float32 gradients lie more than 1e-5 x
max from the float64 step's (the test holds both within 1e-4 of the
port's float64 step), so 1e-5 would sit below float32's own error there.
One module-scoped JAX reference."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from torch import nn as tnn

from videotofaces_tpu.models import facenet as JF
from videotofaces_tpu.train import triplet as JT
from videotofaces_tpu_torch.models import facenet as TF
from videotofaces_tpu_torch.models.wrappers import FaceNetEncoder
from videotofaces_tpu_torch.train import triplet as TT
from videotofaces_tpu_torch.train.optim import AdamW, leaves
from videotofaces_tpu_torch.utils.weights import jax_to_state_dict

from test_torch_facenet import few_threads, jax_facenet_params  # noqa: F401
from torch_train_ref import (GRAD_RTOL, LOSS_RTOL, assert_grads_close,
                             assert_params_after_step, flat_np, jax_update, port_grads,
                             port_params)

HIST_RTOL = 1e-4
DIST_ATOL = 1e-6
FACE_PX, FACE_LR = 75, 1e-5
FACE_GRAD_SHARE = 1e-4
TINY_LR = 1e-3


class TinyEnc(nn.Module):
    """The JAX package's tests/test_train_triplet.py encoder."""

    dim: int = 8

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(8, (3, 3), strides=2)(x)
        x = nn.relu(x)
        x = x.mean(axis=(1, 2))
        return nn.Dense(self.dim)(x)


class TinyEncTorch(tnn.Module):
    """``TinyEnc`` in torch, NCHW: flax's SAME padding of a stride-2 3x3
    convolution on an even size puts the one padded row and column last."""

    def __init__(self, dim=8):
        super().__init__()
        self.Conv_0 = tnn.Conv2d(3, 8, 3, 2)
        self.Dense_0 = tnn.Linear(8, dim)

    def forward(self, x):
        x = torch.relu(self.Conv_0(F.pad(x, (0, 1, 0, 1))))
        return self.Dense_0(x.mean(dim=(2, 3)))


def tiny_twin(params):
    model = TinyEncTorch()
    model.load_state_dict(jax_to_state_dict(params), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def tiny_params(seed, px=12):
    return jax.tree.map(np.asarray, TinyEnc().init(jax.random.PRNGKey(seed),
                                                   jnp.zeros((1, px, px, 3)))["params"])


def class_images(rng, n_per_class, classes=3, size=12, scale=0.3, noise=0.8):
    """Class k = faint base color pattern k + heavy noise (the JAX tests'
    recipe): separable, not yet separated at random init."""
    xs, ys = [], []
    for k in range(classes):
        base = np.zeros((size, size, 3), np.float32)
        base[..., k % 3] = scale
        base[: size // 2, :, (k + 1) % 3] = scale * 0.7
        for _ in range(n_per_class):
            xs.append(base + rng.normal(0, noise, base.shape))
            ys.append(k)
    return np.asarray(xs, np.float32), np.asarray(ys, np.int32)


def face_images(n, seed=3):
    rng = np.random.default_rng(seed)
    import cv2

    return np.stack([cv2.resize(rng.integers(0, 256, (6, 6, 3)).astype(np.uint8),
                                (FACE_PX, FACE_PX), interpolation=cv2.INTER_CUBIC)
                     for _ in range(n)])


def face_params(images):
    """``jax_facenet_params`` with ``head_bn`` calibrated on ``images`` at
    75 px, so that their embeddings spread and the hardest pairs are not
    near-ties."""
    params = jax_facenet_params(seed=2, calibrate=False)
    model = TF.InceptionResnetV1.from_jax(params)
    feats = []
    hook = model.head.register_forward_hook(lambda m, i, o: feats.append(o))
    with torch.no_grad():
        model(_face_batch(images))
    hook.remove()
    f = feats[0].numpy().astype(np.float64)
    params["head_bn"]["mean"] = f.mean(0).astype(np.float32)
    params["head_bn"]["var"] = (f.var(0) + 1e-6).astype(np.float32)
    return params


def _face_batch(images_bgr):
    rgb = torch.from_numpy(np.ascontiguousarray(images_bgr[..., ::-1]))
    return TF.preprocess_uint8(rgb).permute(0, 3, 1, 2).contiguous()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _bank(seed=5):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(10, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, np.asarray([0, 1, 2, 9, 9, 1, 0, 7, 7, 2], np.int32), 16


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: TinyEnc's two steps, FaceNet's step, and the
    histories of the loops."""
    out = {}
    xs, ys = class_images(np.random.default_rng(0), n_per_class=4)
    params = tiny_params(1)
    out["tiny"] = dict(xs=xs, ys=ys, params=params)
    model = TinyEnc()
    bank = JT.MemoryBank(16, 8)
    emb, lab, _ = _bank()
    bank.push(emb, lab)
    be, bl, bv = bank.arrays()
    x, y = jnp.asarray(xs), jnp.asarray(ys)
    for name, fn, extra in (("plain", JT.triplet_loss, ()),
                            ("xbm", JT.triplet_loss_xbm, (be, bl, bv))):
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, *a, fn=fn: fn(p, model, *a), has_aux=True))(params, x, y, *extra)
        out["tiny"][name] = dict(
            loss=float(loss), aux=jax.tree.map(np.asarray, aux), grads=flat_np(grads),
            new=flat_np(jax_update(optax.adamw(TINY_LR), grads, params)))

    images = face_images(16)
    labels = np.repeat(np.arange(4), 4).astype(np.int32)
    fparams = face_params(images[:8])
    fmodel = JF.InceptionResnetV1()
    xf = JF.preprocess_uint8(images[:8][..., ::-1])
    (loss, active), grads = jax.jit(jax.value_and_grad(
        lambda p, a, b: JT.triplet_loss(p, fmodel, a, b), has_aux=True))(
        fparams, jnp.asarray(xf), jnp.asarray(labels[:8]))
    out["face"] = dict(images=images, labels=labels, params=fparams, loss=float(loss),
                       active=float(active), grads=flat_np(grads),
                       new=flat_np(jax_update(optax.adamw(FACE_LR), grads, fparams)))
    _, out["face"]["hist"] = JT.finetune_facenet(images, labels, epochs=2, batch_size=8,
                                                 params=fparams, seed=0)

    xl, yl = class_images(np.random.default_rng(1), n_per_class=6, size=16)
    xl_u8 = np.clip((xl + 2) * 50, 0, 255).astype(np.uint8)
    out["tiny_loops"] = dict(images=xl_u8, labels=yl)
    for bank_size in (0, 12):
        _, out["tiny_loops"][bank_size] = JT.finetune_facenet(
            xl_u8, yl, epochs=2, batch_size=6, learning_rate=TINY_LR, model=TinyEnc(),
            params=tiny_params(2, 16), bank_size=bank_size, seed=4)
    return out


# -- mining and the bank ---------------------------------------------------------


def _unit(rng, n, d):
    e = rng.normal(size=(n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def test_batch_hard_mining_matches_jax():
    rng = np.random.default_rng(0)
    emb, labels = _unit(rng, 24, 16), rng.integers(0, 6, 24).astype(np.int32)
    labels[:3] = 7                                    # an anchor class with positives
    got = TT.batch_hard_mining(torch.from_numpy(emb), torch.from_numpy(labels))
    want = jax.jit(JT.batch_hard_mining)(jnp.asarray(emb), jnp.asarray(labels))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DIST_ATOL)
    np.testing.assert_allclose(TT.pairwise_sq_dists(torch.from_numpy(emb)).numpy(),
                               np.asarray(JT.pairwise_sq_dists(jnp.asarray(emb))),
                               rtol=0, atol=DIST_ATOL)


@pytest.mark.parametrize("bank_fill", [0, 5, 16], ids=["empty", "partial", "full"])
def test_batch_hard_mining_xbm_matches_jax(bank_fill):
    rng = np.random.default_rng(bank_fill)
    emb, labels = _unit(rng, 12, 8), rng.integers(0, 4, 12).astype(np.int32)
    tb, jb = TT.MemoryBank(16, 8, device="cpu"), JT.MemoryBank(16, 8)
    for bank in (tb, jb):
        bank.push(_unit(np.random.default_rng(9), bank_fill, 8),
                  np.random.default_rng(9).integers(0, 6, bank_fill))
    got = TT.batch_hard_mining_xbm(torch.from_numpy(emb), torch.from_numpy(labels),
                                   *tb.arrays())
    want = jax.jit(JT.batch_hard_mining_xbm)(jnp.asarray(emb), jnp.asarray(labels),
                                             *jb.arrays())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DIST_ATOL)


def test_memory_bank_matches_jax():
    tb, jb = TT.MemoryBank(6, 3, device="cpu"), JT.MemoryBank(6, 3)
    rng = np.random.default_rng(2)
    for n in (2, 3, 4, 9):
        emb, lab = rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 9, n)
        tb.push(emb, lab)
        jb.push(emb, lab)
        for t, j in zip(tb.arrays(), jb.arrays()):
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- one step ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "xbm"])
def test_tiny_step_matches_jax(ref, kind):
    r = ref["tiny"]
    want = r[kind]
    model = tiny_twin(r["params"])
    opt = AdamW(leaves(model), TINY_LR)
    x, y = _nchw(r["xs"]), torch.from_numpy(r["ys"])
    if kind == "plain":
        loss, active = TT.train_step(model, opt, x, y)
        want_active = want["aux"]
    else:
        bank = TT.MemoryBank(16, 8, device="cpu")
        bank.push(*_bank()[:2])
        loss, active, emb = TT.train_step_xbm(model, opt, x, y, *bank.arrays())
        want_active, want_emb = want["aux"]
        np.testing.assert_allclose(emb.numpy(), want_emb, rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    assert float(active) == float(want_active)
    assert_grads_close(port_grads(model), want["grads"])
    assert_params_after_step(port_params(model), want["new"], flat_np(r["params"]),
                             want["grads"], TINY_LR)


def test_facenet_step_matches_jax(ref):
    r = ref["face"]
    model = TF.InceptionResnetV1.from_jax(r["params"])
    opt = AdamW(leaves(model), FACE_LR)
    loss, active = TT.train_step(model, opt, _face_batch(r["images"][:8]),
                                 torch.from_numpy(r["labels"][:8]))
    np.testing.assert_allclose(float(loss), r["loss"], rtol=LOSS_RTOL)
    assert 0.0 < float(active) == r["active"]
    got = port_grads(model)
    stats = [k for k in r["grads"] if k.split("/")[-1] in ("mean", "var")]
    assert len(stats) > 200 and all(np.abs(r["grads"][k]).max() > 0 for k in stats)
    assert_grads_close(got, r["grads"], FACE_GRAD_SHARE)
    # both float32 steps against the port's float64 step
    exact = TF.InceptionResnetV1.from_jax(r["params"]).double()
    TT.train_step(exact, AdamW(leaves(exact), FACE_LR), _face_batch(r["images"][:8]).double(),
                  torch.from_numpy(r["labels"][:8]))
    exact_grads = port_grads(exact)
    for grads in (got, r["grads"]):
        assert_grads_close(grads, exact_grads, FACE_GRAD_SHARE)
    # every leaf moves, the statistics too
    assert_params_after_step(port_params(model), r["new"], flat_np(r["params"]), r["grads"],
                             FACE_LR)


# -- the loops ----------------------------------------------------------------------


def test_finetune_facenet_matches_jax(ref):
    r = ref["face"]
    tree, hist = TT.finetune_facenet(r["images"], r["labels"], epochs=2, batch_size=8,
                                     params=r["params"], seed=0, device="cpu")
    np.testing.assert_allclose(hist, r["hist"], rtol=HIST_RTOL)
    base = flat_np(r["params"])
    got = flat_np(tree)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in base.items()}
    assert all(got[k].dtype == np.float32 for k in got)
    assert not np.array_equal(got["head_bn/var"], base["head_bn/var"])
    emb = FaceNetEncoder(device="cpu", params=tree)(list(r["images"][:3]))
    assert emb.shape == (3, 512) and np.isfinite(emb).all()


@pytest.mark.parametrize("bank_size", [0, 12], ids=["no_bank", "bank12"])
def test_finetune_tiny_loops_match_jax(ref, bank_size):
    r = ref["tiny_loops"]
    model = tiny_twin(tiny_params(2, 16))
    tree, hist = TT.finetune_facenet(r["images"], r["labels"], epochs=2, batch_size=6,
                                     learning_rate=TINY_LR, model=model,
                                     bank_size=bank_size, seed=4, device="cpu")
    np.testing.assert_allclose(hist, r[bank_size], rtol=HIST_RTOL)
    assert set(flat_np(tree)) == set(flat_np(tiny_params(2, 16)))


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.finetune_facenet(np.zeros((4, 12, 12, 3), np.uint8), [0, 0, 1, 1],
                            model=tiny_twin(tiny_params(1)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.MemoryBank(4, 2)


# -- the JAX package's single-device tests, on the port -------------------------


def _np_batch_hard(emb, labels):
    b = emb.shape[0]
    d = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
    d_ap, d_an, valid = np.zeros(b), np.zeros(b), np.zeros(b, bool)
    for i in range(b):
        pos = [j for j in range(b) if labels[j] == labels[i] and j != i]
        neg = [j for j in range(b) if labels[j] != labels[i]]
        valid[i] = bool(pos) and bool(neg)
        if valid[i]:
            d_ap[i] = max(d[i, j] for j in pos)
            d_an[i] = min(d[i, j] for j in neg)
    return d_ap, d_an, valid


def test_batch_hard_mining_matches_oracle(rng):
    emb = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=12).astype(np.int32)
    d_ap, d_an, valid = TT.batch_hard_mining(torch.from_numpy(emb), torch.from_numpy(labels))
    e_ap, e_an, e_valid = _np_batch_hard(emb, labels)
    np.testing.assert_array_equal(valid.numpy(), e_valid)
    np.testing.assert_allclose(d_ap.numpy(), e_ap, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_an.numpy(), e_an, rtol=1e-5, atol=1e-6)


def test_mining_handles_all_same_and_all_distinct():
    emb = torch.eye(4, 3)
    assert not TT.batch_hard_mining(emb, torch.zeros(4, dtype=torch.int32))[2].any()
    assert not TT.batch_hard_mining(emb, torch.arange(4, dtype=torch.int32))[2].any()


def test_triplet_training_descends(rng):
    model = tiny_twin(tiny_params(0))
    opt = AdamW(leaves(model), 5e-3)
    xs, ys = class_images(rng, n_per_class=8)
    losses, actives = [], []
    for it in range(80):
        order = np.random.default_rng(it).permutation(len(xs))[:18]
        loss, active = TT.train_step(model, opt, _nchw(xs[order]), torch.from_numpy(ys[order]))
        losses.append(float(loss))
        actives.append(float(active))
    assert np.mean(losses[-5:]) < 0.2 * np.mean(losses[:5]), losses
    assert np.mean(actives[-5:]) < 0.2


def test_xbm_mining_uses_bank_negatives(rng):
    emb = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    labels = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32)
    bank_emb = torch.cat([emb[0:1], torch.full((3, 5), 50.0)])
    bank_labels = torch.tensor([7, 8, 9, 10], dtype=torch.int32)
    bank_valid = torch.tensor([True, True, False, False])
    d_ap0, d_an0, v0 = TT.batch_hard_mining(emb, labels)
    d_ap1, d_an1, v1 = TT.batch_hard_mining_xbm(emb, labels, bank_emb, bank_labels, bank_valid)
    np.testing.assert_array_equal(v0.numpy(), v1.numpy())
    np.testing.assert_allclose(d_ap0.numpy(), d_ap1.numpy(), rtol=1e-6)
    assert float(d_an1[0]) < 1e-6 < float(d_an0[0])
    assert (d_an1 <= d_an0 + 1e-6).all()
    same = torch.zeros(4, dtype=torch.int32)
    _, _, v_batch = TT.batch_hard_mining(emb[:4], same)
    _, d_an_b, v_bank = TT.batch_hard_mining_xbm(emb[:4], same, bank_emb, bank_labels,
                                                 bank_valid)
    assert not v_batch.any() and v_bank.all()
    assert torch.isfinite(d_an_b).all()


def test_memory_bank_fifo():
    bank = TT.MemoryBank(4, 2, device="cpu")
    assert not bank.valid.any()
    bank.push(np.ones((2, 2)), [1, 2])
    assert list(bank.labels) == [1, 2, -1, -1]
    bank.push(2 * np.ones((3, 2)), [3, 4, 5])
    assert sorted(bank.labels[bank.valid]) == [2, 3, 4, 5]
    bank.push(np.arange(12).reshape(6, 2), [6, 7, 8, 9, 10, 11])
    assert sorted(bank.labels) == [8, 9, 10, 11]


def test_finetune_with_bank_descends(rng):
    xs, ys = class_images(rng, n_per_class=8)
    xs_u8 = np.clip((xs + 2) * 50, 0, 255).astype(np.uint8)
    _, hist = TT.finetune_facenet(xs_u8, ys, epochs=8, batch_size=12, learning_rate=5e-3,
                                  model=tiny_twin(tiny_params(3)), bank_size=16,
                                  device="cpu")
    assert len(hist) == 8 and all(np.isfinite(h) for h in hist)
    assert hist[-1] < hist[0], hist


def test_finetune_facenet_loop_with_injected_model(rng):
    params = tiny_params(2, 16)
    xs = (rng.random((20, 16, 16, 3)) * 255).astype(np.uint8)
    ys = np.repeat(np.arange(4), 5)
    out, history = TT.finetune_facenet(xs, ys, epochs=2, batch_size=8, learning_rate=1e-3,
                                       model=TinyEncTorch(), params=params, device="cpu")
    assert len(history) == 2 and all(np.isfinite(h) for h in history)
    before, after = flat_np(params), flat_np(out)
    assert any(not np.allclose(after[k], before[k]) for k in before)

