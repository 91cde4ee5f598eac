"""The port's MTCNN ops against the JAX package's, on the same numpy inputs.
Everything here must agree EXACTLY: the masks and indices decide which
candidates survive, and the pools are exact int32 sums and one division.
Scores are drawn from a small set of values, so ties are common and the
stable tie order is exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.ops import boxes as JB
from videotofaces_tpu.ops import nms as JN
from videotofaces_tpu.ops import resize as JR
from videotofaces_tpu_torch.ops import boxes as TB
from videotofaces_tpu_torch.ops import nms as TN
from videotofaces_tpu_torch.ops import resize as TR


def _boxes(rng, b, k, span=60.0):
    xy = rng.uniform(0, span, (b, k, 2))
    wh = rng.uniform(2, 25, (b, k, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _scores(rng, b, k):
    return rng.choice(np.asarray([0.3, 0.5, 0.7, 0.7, 0.9], np.float32), (b, k))


@pytest.fixture
def inputs():
    rng = np.random.default_rng(11)
    b, k = 3, 400
    valid = rng.random((b, k)) < 0.8
    valid[2, 200:] = False          # one row fits the 256 bucket
    assert valid[:2].sum(1).min() > 256
    return _boxes(rng, b, k), _scores(rng, b, k), valid


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("mode", ["iou", "iom"])
def test_box_iou_matrix_exact(inputs, plus_one, mode):
    boxes = inputs[0][0]
    want = np.asarray(JB.box_iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes),
                                        plus_one=plus_one, mode=mode))
    got = TB.box_iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes),
                            plus_one=plus_one, mode=mode).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_keep_mask_exact(inputs):
    boxes, scores, valid = inputs
    for i in range(boxes.shape[0]):
        want = np.asarray(JN.nms_keep_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                           jnp.asarray(valid[i]), 0.5))
        got = TN.nms_keep_mask(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]),
                               torch.from_numpy(valid[i]), 0.5).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < valid[i].sum()   # suppression happened


@pytest.mark.parametrize("rows", [slice(0, 3), slice(2, 3)], ids=["full", "bucket"])
def test_nms_keep_mask_bucketed_exact(inputs, rows):
    """Both branches: a row with > 256 valid slots runs the full problem,
    a batch whose rows all fit runs the [256, 256] one."""
    boxes, scores, valid = (a[rows] for a in inputs)
    want = np.asarray(JN.nms_keep_mask_bucketed(jnp.asarray(boxes), jnp.asarray(scores),
                                                jnp.asarray(valid), 0.7))
    got = TN.nms_keep_mask_bucketed(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    torch.from_numpy(valid), 0.7).numpy()
    np.testing.assert_array_equal(got, want)


def test_iom_chain_suppress_exact(inputs):
    boxes, scores, valid = inputs
    want = np.asarray(jax.vmap(lambda b, s, v: JN.iom_chain_suppress(b, s, v, 0.7))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))
    got = TN.iom_chain_suppress(torch.from_numpy(boxes), torch.from_numpy(scores),
                                torch.from_numpy(valid), 0.7).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_by_score_exact(inputs):
    _, scores, valid = inputs
    for k in (1, 17, 400):
        want_i, want_v = jax.vmap(lambda s, m: JN.topk_by_score(s, m, k))(
            jnp.asarray(scores), jnp.asarray(valid))
        got_i, got_v = TN.topk_by_score(torch.from_numpy(scores),
                                        torch.from_numpy(valid), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        # indices of invalid slots are padding on both sides; valid ones,
        # ties included, come in the same order
        v = np.asarray(want_v)
        np.testing.assert_array_equal(got_i.numpy()[v], np.asarray(want_i)[v])


@pytest.mark.parametrize("out_hw", [(97, 131), (40, 56), (15, 21), (7, 9)])
def test_adaptive_pool_full_exact(out_hw):
    frames = np.random.default_rng(3).integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    want = np.asarray(JR.adaptive_pool_full(JR.integral_image(jnp.asarray(frames)),
                                            out_hw, (40, 56)))
    got = TR.adaptive_pool_full(TR.integral_image(torch.from_numpy(frames)),
                                out_hw, (40, 56)).numpy()
    np.testing.assert_array_equal(got, want)
    assert TR.pool_windows_le2(out_hw, (40, 56)) == JR.pool_windows_le2(out_hw, (40, 56))


def test_adaptive_pool_boxes_batched_exact():
    rng = np.random.default_rng(4)
    b, h, w = 2, 50, 70
    frames = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    n = 40
    x1, y1 = rng.integers(0, w - 1, n), rng.integers(0, h - 1, n)
    x2 = np.minimum(w, x1 + rng.integers(1, 60, n))
    y2 = np.minimum(h, y1 + rng.integers(1, 45, n))
    wins = np.stack([x1, y1, x2, y2], axis=1).astype(np.int32)
    img = rng.integers(0, b, n).astype(np.int32)
    for out in (24, 48):
        want = np.asarray(JR.adaptive_pool_boxes_batched(
            JR.integral_image(jnp.asarray(frames)), jnp.asarray(wins),
            jnp.asarray(img), (out, out)))
        got = TR.adaptive_pool_boxes_batched(
            TR.integral_image(torch.from_numpy(frames)), torch.from_numpy(wins),
            torch.from_numpy(img), (out, out)).numpy()
        np.testing.assert_array_equal(got, want)
