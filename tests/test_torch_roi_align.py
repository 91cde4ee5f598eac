"""The Faster R-CNN ops of the port against the JAX package's, jitted, on the
same numpy-seeded inputs: anchors and priors, box ops, NMS with groups, the
matrix-form resize onto a canvas, FPN level assignment, the RoIAlign axis
weights (bit for bit) and the plain multilevel RoIAlign (against the dense
method in "highest" and against the Pallas engine in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu import config as jconfig
from videotofaces_tpu.models import rcnn as JR
from videotofaces_tpu.ops import anchors as JA
from videotofaces_tpu.ops import boxes as JB
from videotofaces_tpu.ops import nms as JN
from videotofaces_tpu.ops import resize as JRS
from videotofaces_tpu.ops import roi_align as JRA
from videotofaces_tpu_torch.models import rcnn as TRC
from videotofaces_tpu_torch.ops import anchors as TA
from videotofaces_tpu_torch.ops import boxes as TB
from videotofaces_tpu_torch.ops import nms as TN
from videotofaces_tpu_torch.ops import resize as TRS
from videotofaces_tpu_torch.ops import roi_align as TRA

STRIDES = (4, 8, 16, 32)
SIZES = [(64, 96), (32, 48), (16, 24), (8, 12)]      # a 256 x 384 canvas
# float32 on both sides; the products sum in another order
F32_TOL = dict(rtol=0, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_anchors_and_priors_equal_jax():
    assert TA.make_anchors([32, 64], [1, 2], [2, 1, 0.5]) == \
        JA.make_anchors([32, 64], [1, 2], [2, 1, 0.5])
    for canvas in [(64, 96), (768, 1344)]:
        got = TA.get_priors(canvas, TRC.frcnn_bases(), loc="corner", concat=False)
        want = JA.get_priors(canvas, JR.frcnn_bases(), loc="corner", concat=False)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(TA.get_priors((40, 56), [(8, [16, 24])]),
                                  JA.get_priors((40, 56), [(8, [16, 24])]))


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(0, 0.5, (3, 50, 4)).astype(np.float32)
    pri = np.concatenate([rng.uniform(0, 90, (3, 50, 2)), rng.uniform(2, 60, (3, 50, 2))],
                         -1).astype(np.float32)
    for mults in [(1.0, 1.0), (0.1, 0.2)]:
        want = jax.jit(lambda p, q: JB.decode_boxes(p, q, mults=mults))(pred, pri)
        np.testing.assert_allclose(TB.decode_boxes(_t(pred), _t(pri), mults).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-5)
    boxes = np.asarray(JB.decode_boxes(pred, pri))
    np.testing.assert_allclose(TB.convert_to_cwh(_t(boxes)).numpy(),
                               np.asarray(jax.jit(JB.convert_to_cwh)(boxes)), rtol=0, atol=1e-5)
    hw = np.asarray([[60.0, 90.0], [64.0, 80.0], [30.0, 96.0]], np.float32)[:, None, :]
    np.testing.assert_array_equal(TB.clamp_to_canvas(_t(boxes), _t(hw)).numpy(),
                                  np.asarray(jax.jit(JB.clamp_to_canvas)(boxes, hw)))
    for m in (0.0, 5.0):
        np.testing.assert_array_equal(TB.small_boxes_mask(_t(boxes), m).numpy(),
                                      np.asarray(JB.small_boxes_mask(boxes, m)))


def test_nms_with_group_ids_equals_jax():
    """torchvision ``batched_nms`` semantics: boxes suppress only within
    their group; both the sorting and the presorted entry."""
    rng = np.random.default_rng(1)
    k = 120
    xy = rng.uniform(0, 60, (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (k, 2))], 1).astype(np.float32)
    scores = rng.random(k).astype(np.float32)
    valid = rng.random(k) < 0.9
    groups = rng.integers(0, 3, k).astype(np.int32)
    want = np.asarray(jax.jit(lambda b, s, v, g: JN.nms_keep_mask(b, s, v, 0.5, g))(
        boxes, scores, valid, groups))
    got = TN.nms_keep_mask(_t(boxes), _t(scores), _t(valid), 0.5, _t(groups)).numpy()
    np.testing.assert_array_equal(got, want)
    ungrouped = TN.nms_keep_mask(_t(boxes), _t(scores), _t(valid), 0.5).numpy()
    assert got.sum() > ungrouped.sum()           # the groups kept more
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    pres = TN.nms_keep_mask(_t(boxes[order]), None, _t(valid[order]), 0.5, _t(groups[order]),
                            presorted=True).numpy()
    np.testing.assert_array_equal(pres, want[order])


def test_bilinear_resize_matmul_with_canvas_matches_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 48, 72, 3)).astype(np.uint8)
    with jconfig.precision_scope("highest"):
        for out, canvas in [((40, 60), (64, 64)), ((90, 130), None)]:
            want = np.asarray(jax.jit(lambda x: JRS.bilinear_resize_matmul(
                x, out, canvas_hw=canvas))(frames))
            got = TRS.bilinear_resize_matmul(_t(frames), out, canvas_hw=canvas).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(TRS._bilinear_matrix(48, 40), JRS._bilinear_matrix(48, 40))


def test_levels_at_the_boundaries_equal_jitted_jax():
    """sqrt(wh) of 112, 224 and 448 (and 4 float32 ulps either side) sit on
    the level edges; the port's comparison form gives the jitted JAX
    levels, on either side of each edge."""
    sides = []
    for v in (112.0, 224.0, 448.0):
        s = np.float32(v)
        for _ in range(4):
            s = np.nextafter(s, np.float32(0))
        for _ in range(9):
            sides.append(s)
            s = np.nextafter(s, np.float32(1e9))
    sides = np.asarray(sides + [1.0, 50.0, 1000.0, 5000.0], np.float32)
    boxes = np.stack([np.zeros_like(sides), np.full_like(sides, 3.0), sides, sides + 3.0], 1)
    want = np.asarray(jax.jit(JRA.assign_fpn_levels)(boxes))
    got = TRA.assign_fpn_levels(_t(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(set(want.tolist())) == [0, 1, 2, 3]
    ulps_below = [int(np.float32(v).view(np.int32) - np.float32(e).view(np.int32))
                  for v, e in zip((112, 224, 448), TRA.LEVEL_EDGES)]
    assert ulps_below == [1, 1, 2]
    rng = np.random.default_rng(3)
    w, h = rng.uniform(0, 900, (2, 4000)).astype(np.float32)
    rand = np.stack([np.zeros_like(w), np.zeros_like(w), w, h], 1)
    np.testing.assert_array_equal(TRA.assign_fpn_levels(_t(rand)).numpy(),
                                  np.asarray(jax.jit(JRA.assign_fpn_levels)(rand)))


@pytest.mark.parametrize("extent", [48, 192, 7])
def test_axis_weights_equal_jitted_jax_bit_for_bit(extent):
    """Spans of exactly 21 feature units (jitted JAX samples k = 4 there;
    the exact ceil(21 / 7) is 3), random spans, and spans with k > 8."""
    rng = np.random.default_rng(extent)
    n = 1500
    c1 = rng.uniform(-2, extent, n).astype(np.float32)
    span = rng.uniform(0, 70, n).astype(np.float32)
    span[:300] = 21.0
    c1[:300] = np.round(c1[:300]) - 0.5                  # c2 - c1 is exactly 21
    span[300:350] = rng.uniform(57, 200, 50)             # k = 9 .. 29
    c2 = (c1 + span).astype(np.float32)

    def jax_weights(a, b):
        k = jnp.ceil(jnp.maximum(b - a, 0.0) / 7).astype(jnp.int32)
        return k, JRA._axis_weights(a, b, extent, k, jnp.zeros(a.shape, jnp.int32), extent)

    jk, want = (np.asarray(x) for x in jax.jit(jax_weights)(c1, c2))
    a, b = _t(c1), _t(c2)
    k = TRA.samples_per_bin(a, b)
    np.testing.assert_array_equal(k.numpy(), jk)
    assert (jk[:300] == 4).all() and np.ceil(np.float32(21) / np.float32(7)) == 3
    assert jk.max() > 8
    got = TRA._axis_weights(a, b, extent, k, torch.zeros(n, dtype=torch.int64), extent)
    np.testing.assert_array_equal(got.numpy(), want)


def _pyramid(rng, b, c, dtype=np.float32):
    return [rng.normal(0, 1, (b, h, w, c)).astype(dtype) for h, w in SIZES]


BOXES = np.asarray([
    [10.0, 12.0, 90.0, 100.0],      # P2
    [4.0, 4.0, 180.0, 160.0],       # P3
    [0.0, 0.0, 256.0, 256.0],       # P4
    [0.0, 0.0, 383.0, 255.0],       # P4
    [2.5, 3.5, 20.25, 17.75],       # small, fractional
    [100.0, 50.0, 101.0, 51.0],     # 1 px
    [0.0, 10.0, 380.0, 29.0],       # 1:20 aspect ratio: k = 14 > 8 on P2
    [30.0, 30.0, 30.0, 60.0],       # zero width
    [200.0, 100.0, 580.0, 400.0],   # runs off the canvas
    [5.5, 1.0, 89.5, 85.0],         # a 21-unit span on P2
], np.float32)


def test_roi_align_plain_matches_dense_jax_highest():
    rng = np.random.default_rng(4)
    fmaps = _pyramid(rng, 2, 8)
    boxes = np.stack([BOXES, BOXES[::-1] + 3.0])
    valid = np.ones(boxes.shape[:2], bool)
    with jconfig.precision_scope("highest"):
        want = np.stack([np.asarray(jax.jit(
            lambda fs, bx: JRA.roi_align_multilevel(fs, bx, STRIDES, chunk=4))(
                [f[i] for f in fmaps], boxes[i])) for i in range(2)])
    pooled, dropped, kept, truncated = TRA.roi_align_fpn(
        [_t(f) for f in fmaps], _t(boxes), _t(valid))
    assert pooled.shape == (2, len(BOXES), 7, 7, 8) and pooled.dtype == torch.float32
    np.testing.assert_allclose(pooled.numpy(), want, **F32_TOL)
    assert dropped.tolist() == [0, 0] and truncated.tolist() == [0, 0]
    np.testing.assert_array_equal(kept.numpy(), valid)
    k = TRA.samples_per_bin(*(_t(BOXES[6:7, i]) / 4 - 0.5 for i in (0, 2)))
    assert int(k) == 14


def test_roi_align_invalid_slots_are_zero():
    rng = np.random.default_rng(5)
    fmaps = [_t(f) for f in _pyramid(rng, 1, 4)]
    boxes = _t(BOXES[None, :4])
    valid = torch.tensor([[True, False, True, False]])
    pooled, _, kept, _ = TRA.roi_align_fpn(fmaps, boxes, valid)
    full = TRA.roi_align_fpn_plain(fmaps, boxes, torch.ones_like(valid))
    assert (pooled[~valid] == 0).all() and (full[~valid] != 0).any()
    torch.testing.assert_close(pooled[valid], full[valid], rtol=0, atol=0)
    assert torch.equal(kept, valid)


def test_roi_align_plain_bf16_close_to_pallas_interpret():
    """bfloat16 levels: the plain version reads them as float32 with float32
    weights; the JAX Pallas engine rounds the roi coordinates to 16.16
    fixed point and its weights, and their joint products, to bfloat16
    (2^-8 relative each). Tolerance: 2^-6 x max|feature|, two such
    roundings on each of the taps of a bin's average."""
    rng = np.random.default_rng(6)
    fmaps = [f.astype(jnp.bfloat16) for f in _pyramid(rng, 2, 8)]
    boxes = np.stack([BOXES[:6], BOXES[:6][::-1] + 2.0])
    valid = np.ones(boxes.shape[:2], bool)
    valid[1, 2] = False
    want, dropped, kept, _ = JRA.roi_align_multilevel_pallas(
        [jnp.asarray(f) for f in fmaps], jnp.asarray(boxes), jnp.asarray(valid), STRIDES,
        main_hw=(24, 24), big_hw=(40, 48), big_cap=4, interpret=True)
    assert np.asarray(dropped).tolist() == [0, 0]
    np.testing.assert_array_equal(np.asarray(kept), valid)
    tf = [torch.from_numpy(np.asarray(f, np.float32)).to(torch.bfloat16) for f in fmaps]
    got = TRA.roi_align_fpn(tf, _t(boxes), _t(valid))[0].numpy()
    amax = max(float(np.abs(np.asarray(f, np.float32)).max()) for f in fmaps)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2.0 ** -6 * amax)
    assert np.abs(got - np.asarray(want)).max() > 0    # the engines do differ


def test_roi_align_fpn_rejects_bad_inputs():
    f = [torch.zeros(1, h, w, 4) for h, w in SIZES]
    boxes = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError):
        TRA.roi_align_fpn(f, boxes.double(), torch.ones(1, 3, dtype=torch.bool))
    with pytest.raises(ValueError):
        TRA.roi_align_fpn(f, boxes, torch.ones(1, 3))                # float valid
    with pytest.raises(ValueError):
        TRA.roi_align_fpn(f[:3] + [torch.zeros(1, 8, 12, 5)], boxes,
                          torch.ones(1, 3, dtype=torch.bool))         # channel mismatch
