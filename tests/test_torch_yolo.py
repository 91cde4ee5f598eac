"""The port's YOLOv3 (Darknet-53 + neck + head, postprocess, full forward)
and ``YoloDetector`` against the JAX package's, jitted, on the same
numpy-seeded parameters converted by ``utils.weights.yolo_from_jax``.

Also home of ``jax_yolo_params``, the parameter tree the port's live-path
tests feed to both packages."""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu import config as jconfig
from videotofaces_tpu.models import yolo as JY
from videotofaces_tpu.models.wrappers import YoloDetector as JaxDetector
from videotofaces_tpu.ops.boxes import decode_boxes as jax_decode_boxes
from videotofaces_tpu.ops.select import block_topk_select
from videotofaces_tpu_torch import config
from videotofaces_tpu_torch.models import yolo as TY
from videotofaces_tpu_torch.models.wrappers import YoloDetector
from videotofaces_tpu_torch.ops.boxes import box_iou_matrix, decode_boxes
from videotofaces_tpu_torch.utils.weights import yolo_from_jax

from test_torch_facenet import few_threads  # noqa: F401

# float32 on both sides, different convolution algorithms through 75 layers
MAP_TOL = dict(rtol=1e-4, atol=1e-4)
# the bounds tests/test_models_yolo.py holds the JAX postprocess to its oracle
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
BOX_TOL = dict(rtol=1e-3, atol=1e-2)             # pixels
# bfloat16: the two packages round their convolutions' outputs at other
# places, so a few near-tied candidates and NMS decisions flip; a detection
# matches when a detection of the other side overlaps it at IoU >= 0.99
BF16_IOU, BF16_MATCHED = 0.99, 0.85
FRAME_HW, MAX_SIDE = (120, 160), 160             # canvas 128 x 160, D = 1,260


@functools.lru_cache(maxsize=1)
def _jax_yolo_shapes():
    return jax.eval_shape(JY.YOLOv3().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))["params"]


def jax_yolo_params(seed=0, head_shift=0.0, reg_scale=0.1):
    """YOLOv3 {"backbone", "neck", "head"} tree in the JAX layout, drawn
    with numpy: kernels N(0, 1.6/fan_in) (the gain that carries the input's
    signal through the leaky-ReLU stack to O(1) head maps; with 1/fan_in
    the maps hardly depend on the input), BatchNorm scale 1 + N(0, 0.1)
    (0.2x on each residual block's second unit, so that the residual stream
    does not blow up), var 0.8 + |N| * 0.2, biases and means N(0, 0.1); the
    heads' regression columns x ``reg_scale`` (so that boxes stay near
    their anchors, as real detections do), and their objectness and class biases
    (``pred*/bias[4::6]``, ``[5::6]``) shifted by ``head_shift`` so that
    detections pass a score threshold."""
    rng = np.random.default_rng(seed)

    def rnd(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        name = keys[-1]
        x = rng.normal(0.0, 1.0, a.shape).astype(np.float32)
        if name == "kernel":
            x *= np.float32(np.sqrt(1.6 / np.prod(a.shape[:-1])))
        elif name == "var":
            x = np.abs(x) * 0.2 + 0.8
        elif name == "scale":
            x = (0.2 if keys[-3] == "conv2" and "_res" in keys[-4] else 1.0) * (1.0 + 0.1 * x)
        else:                                         # bias, mean
            x *= np.float32(0.1)
        if keys[-2].startswith("pred"):
            if name == "kernel":
                x[..., (np.arange(x.shape[-1]) % 6) < 4] *= np.float32(reg_scale)
            else:
                x[4::6] += head_shift
                x[5::6] += head_shift
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(rnd, _jax_yolo_shapes())


def smooth_frames(seed, n, h=FRAME_HW[0], w=FRAME_HW[1]):
    rng = np.random.default_rng(seed)
    return np.stack([cv2.resize(rng.integers(0, 256, (h // 10, w // 10, 3)).astype(np.uint8),
                                (w, h), interpolation=cv2.INTER_CUBIC) for _ in range(n)])


def synthetic_maps(seed, canvas, b=2, loc=-2.2, scale=1.2):
    """Seeded NHWC head maps [B, H/s, W/s, 18] for s = 32, 16, 8 (the JAX
    layout): about half the candidates pass the score thresholds."""
    rng = np.random.default_rng(seed)
    return [rng.normal(loc, scale, (b, canvas[0] // s, canvas[1] // s, 18)).astype(np.float32)
            for s in (32, 16, 8)]


def _nchw(maps):
    return [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps]


@pytest.fixture(scope="module")
def params():
    return jax_yolo_params(0)


@pytest.fixture(scope="module")
def model(params):
    return TY.YOLOv3.from_jax(params).eval()


def test_yolo_from_jax_layout(params, model):
    sd = yolo_from_jax(params)
    b, n, h = params["backbone"], params["neck"], params["head"]
    np.testing.assert_array_equal(
        sd["backbone.stage3_res5.conv2.conv.weight"].numpy(),
        b["stage3_res5"]["conv2"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["backbone.conv1.bn.running_var"].numpy(),
                                  b["conv1"]["bn"]["var"])
    np.testing.assert_array_equal(sd["neck.detect2.c3.bn.weight"].numpy(),
                                  n["detect2"]["c3"]["bn"]["scale"])
    np.testing.assert_array_equal(sd["head.pred2.weight"].numpy(),
                                  h["pred2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.pred0.bias"].numpy(), h["pred0"]["bias"])
    # every leaf lands on a state-dict entry of the same size, none is left over
    assert set(sd) == set(model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len([k for k in sd if not k.endswith("num_batches_tracked")])
    for path, a in leaves:
        assert a.size == sd[_sd_key(path)].numel()
    # and round-trips: the module's parameters are the tree's values
    msd = model.state_dict()
    for path, a in leaves:
        got = msd[_sd_key(path)].numpy()
        np.testing.assert_array_equal(got.transpose(2, 3, 1, 0) if got.ndim == 4 else got, a)


def _sd_key(path):
    keys = [str(getattr(p, "key", p)) for p in path]
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    if keys[-1] == "kernel":
        keys[-1] = "weight"
    elif keys[-2] == "bn":
        keys[-1] = bn[keys[-1]]
    return ".".join(keys)


def test_head_maps_match_flax(params, model):
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    with jconfig.precision_scope("highest"):
        want = jax.jit(lambda p, a: JY.YOLOv3().apply({"params": p}, a))(params, x)
    with config.precision_scope("highest"), torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(1, 18, 2, 3), (1, 18, 4, 6), (1, 18, 8, 12)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.1
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, **MAP_TOL)


def test_decode_boxes_yolo_matches_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 3, (50, 4)).astype(np.float32)
    priors = rng.uniform(5, 300, (50, 4)).astype(np.float32)
    strides = rng.choice([8.0, 16.0, 32.0], (50, 1)).astype(np.float32)
    for clamp in (False, True):
        want = jax_decode_boxes(jnp.asarray(pred), jnp.asarray(priors), mode="yolo",
                                strides=jnp.asarray(strides), clamp=clamp)
        got = decode_boxes(torch.from_numpy(pred), torch.from_numpy(priors), mode="yolo",
                           strides=torch.from_numpy(strides), clamp=clamp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError):
        decode_boxes(torch.from_numpy(pred), torch.from_numpy(priors), mode="ssd")


def _jax_postprocess(maps, canvas, **kw):
    priors, strides = JY.flat_priors_and_strides(canvas)
    fn = jax.jit(lambda ms: JY.postprocess(ms, jnp.asarray(priors), jnp.asarray(strides),
                                           **kw))
    return [np.asarray(a) for a in fn([jnp.asarray(m) for m in maps])]


def _port_postprocess(maps, canvas, **kw):
    priors, strides = JY.flat_priors_and_strides(canvas)
    out = TY.postprocess(_nchw(maps), torch.from_numpy(priors), torch.from_numpy(strides),
                         **kw)
    return [t.numpy() for t in out]


def _assert_same_detections(got, want, min_valid=5):
    """Equal valid masks; scores and boxes at the JAX postprocess's own
    bounds; equal classes; the overflow counters 0."""
    v = want[3]
    assert v.sum(1).min() >= min_valid, "too few detections — reseed the test"
    np.testing.assert_array_equal(got[3], v)
    np.testing.assert_allclose(got[1][v], want[1][v], **SCORE_TOL)
    np.testing.assert_allclose(got[0][v], want[0][v], **BOX_TOL)
    np.testing.assert_array_equal(got[2][v], want[2][v])
    assert got[4].tolist() == [0] * len(v) == want[4].tolist()


@pytest.mark.parametrize("canvas", [(96, 128), (128, 160)])
@pytest.mark.parametrize("pre_topk", [600, 1000])
def test_postprocess_matches_jax(canvas, pre_topk):
    """Where the JAX block selection is exact (its ``overflow`` 0), the
    port's exact sort selects the same candidates."""
    maps = synthetic_maps(3, canvas)
    with jconfig.precision_scope("highest"):
        want = _jax_postprocess(maps, canvas, pre_topk=pre_topk)
    got = _port_postprocess(maps, canvas, pre_topk=pre_topk)
    assert got[0].shape == want[0].shape == (2, 100, 4)
    _assert_same_detections(got, want)


def test_postprocess_1080p_selection_is_exact_where_jax_overflows():
    """The 1080p canvas (352 x 608, D = 13,167 in 103 lane blocks) with
    dense candidates and the level-32 map's objectness raised, so that its
    first five blocks hold far more than 20 of the top 1,000: the JAX
    package's ``block_topk_select(per_block=20)`` drops candidates and says
    so (``overflow > 0``); the port's selection is the exact stable top
    1,000 and keeps candidates the JAX package dropped."""
    canvas = (352, 608)
    maps = synthetic_maps(4, canvas, b=1, loc=0.5, scale=1.0)
    maps[0][..., 4::6] += 3.0
    priors, strides = JY.flat_priors_and_strides(canvas)
    assert len(priors) == 13167
    with jconfig.precision_scope("highest"):
        want = _jax_postprocess(maps, canvas)
    assert want[4][0] > 0
    got = _port_postprocess(maps, canvas)
    assert got[4].tolist() == [0] and got[3].sum() > 0

    vals, idx, _ = TY.select_candidates(_nchw(maps))
    flat = np.concatenate([m.reshape(1, -1, 6) for m in maps], axis=1)[0]
    obj, cls = 1 / (1 + np.exp(-flat[:, 4])), 1 / (1 + np.exp(-flat[:, 5]))
    masked = np.where((obj >= 0.005) & (cls > 0.05), cls * obj, 0).astype(np.float32)
    exact = np.argsort(-masked, kind="stable")[:1000]
    np.testing.assert_array_equal(idx[0].numpy(), exact)
    np.testing.assert_allclose(vals[0].numpy(), masked[exact], rtol=1e-6)

    # the JAX selection, carrying each candidate's index as its payload
    jvals, jsel, jover = block_topk_select(
        jnp.asarray(masked[None]), jnp.arange(len(masked), dtype=jnp.float32)[None, :, None],
        1000, per_block=20)
    assert int(jover[0]) > 0
    dropped = set(exact.tolist()) - set(np.asarray(jsel)[0, :, 0].astype(int).tolist())
    assert dropped


def _jax_full_forward(params, frames, canvas, resized, **kw):
    priors, strides = JY.flat_priors_and_strides(canvas)
    fn = jax.jit(lambda p, x: JY.full_forward(p, x, resized, canvas, jnp.asarray(priors),
                                              jnp.asarray(strides), **kw))
    return [np.asarray(a) for a in fn(params, jnp.asarray(frames))]


def _port_full_forward(model, frames, canvas, resized, **kw):
    priors, strides = JY.flat_priors_and_strides(canvas)
    with torch.no_grad():
        out = TY.full_forward(model, torch.from_numpy(frames), resized, canvas,
                              torch.from_numpy(priors), torch.from_numpy(strides), **kw)
    return [t.float().numpy() if t.is_floating_point() else t.numpy() for t in out]


def _small_geometry():
    resized = TY.resized_shape(*FRAME_HW, MAX_SIDE)
    return resized, TY.canvas_shape(*resized)


@pytest.mark.parametrize("host_resize", [False, True], ids=["device_resize", "host_resize"])
def test_full_forward_highest_matches_jax(params, model, host_resize):
    """f32 "highest": the device resize (``bilinear_resize_matmul``) and the
    host-cv2 order (``orig_hw``: frames arrive resized) on 2 frames of
    120 x 160 at ``max_side`` 160 (resized 120 x 160 onto 128 x 160)."""
    frames = smooth_frames(1, 2)
    resized, canvas = _small_geometry()
    kw = {}
    if host_resize:
        frames = np.stack([cv2.resize(f, resized[::-1], interpolation=cv2.INTER_LINEAR)
                           for f in frames])
        kw = dict(orig_hw=FRAME_HW)
    with jconfig.precision_scope("highest"):
        want = _jax_full_forward(params, frames, canvas, resized, **kw)
    with config.precision_scope("highest"):
        got = _port_full_forward(model, frames, canvas, resized, **kw)
    _assert_same_detections(got, want)


def _matched(a, b):
    """Share of the boxes of ``a`` that a box of ``b`` overlaps at IoU >=
    BF16_IOU."""
    if len(a) == 0:
        return 1.0
    iou = box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return float((iou.max(1) >= BF16_IOU).mean()) if len(b) else 0.0


def test_full_forward_bf16_close_to_jax(params):
    """bf16 throughput mode (uint8-canvas preprocess, bf16 network) against
    the JAX package's bf16 graph without its space-to-depth stem: at least
    BF16_MATCHED of each side's detections have a partner at IoU >= 0.99."""
    frames = smooth_frames(1, 2)
    resized, canvas = _small_geometry()
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    with jconfig.precision_scope("default"):
        want = _jax_full_forward(p16, frames, canvas, resized, compute_dtype=jnp.bfloat16,
                                 s2d=False)
    m16 = TY.YOLOv3.from_jax(params).to(torch.bfloat16).eval()
    with config.precision_scope("default"):
        got = _port_full_forward(m16, frames, canvas, resized, compute_dtype=torch.bfloat16)
    for i in range(2):
        wb, gb = want[0][i][want[3][i]], got[0][i][got[3][i]]
        assert len(wb) > 5
        assert abs(len(gb) - len(wb)) <= (1 - BF16_MATCHED) * len(wb)
        assert _matched(wb, gb) >= BF16_MATCHED and _matched(gb, wb) >= BF16_MATCHED


@pytest.mark.parametrize("host_resize", [False, True], ids=["device_resize", "host_resize"])
def test_detector_matches_jax(params, host_resize):
    """``YoloDetector`` submit / collect on 120 x 160 frames at ``max_side``
    160, a batch of 3 padded to 4, in "highest"."""
    frames = list(smooth_frames(2, 3))
    kw = dict(params=params, batch_size=4, max_side=MAX_SIDE, host_resize=host_resize)
    with jconfig.precision_scope("highest"):
        want = JaxDetector(mesh=None, **kw)(frames)
    det = YoloDetector(device="cpu", **kw)
    with config.precision_scope("highest"):
        got = det.collect(det.submit(frames))
    assert det.device.type == "cpu"
    for g, w in zip(got, want):          # boxes, scores, classes
        assert len(g) == len(w) == 3
        for gi, wi in zip(g, w):
            assert gi.shape == wi.shape
            np.testing.assert_allclose(gi, wi, **(SCORE_TOL if gi.ndim == 1 else BOX_TOL))
    assert min(len(b) for b in want[0]) > 5


def test_collect_warns_per_counter(capsys):
    """``_BoxDetectorBase.collect`` takes YOLO's one counter or the Faster
    R-CNN's three, and each set counter prints its own detector's warning;
    YOLO's per-image tally after its counter (the candidates entering NMS)
    is recorded as one ``yolo:candidates`` counter, summed over the batch's
    real images."""
    from types import SimpleNamespace

    from videotofaces_tpu_torch.models.wrappers import FrcnnDetector
    from videotofaces_tpu_torch.utils import profiling

    def handle(*counters):
        out = (torch.zeros((3, 3, 4)), torch.ones((3, 3)),
               torch.zeros((3, 3), dtype=torch.int32),
               torch.tensor([[True, True, False], [True, False, False], [True, True, True]]))
        return (out + tuple(torch.tensor(c, dtype=torch.int32) for c in counters), None), 2

    for cls, counters, words in ((YoloDetector, ([0, 3, 0],), ["YOLO candidate selection"]),
                                 (FrcnnDetector, ([2, 0, 0], [0, 1, 0], [4, 0, 0]),
                                  ["FasterRCNN RPN two-pass NMS", "FasterRCNN RoIAlign dropped",
                                   "FasterRCNN RoIAlign ran"])):
        det = SimpleNamespace(_name=cls._name, _counter_warnings=cls._counter_warnings,
                              _tallies=cls._tallies)
        tallies = [[5, 7, 100]] * len(cls._tallies)     # the third image is padding
        timer = profiling.StageTimer()
        with profiling.recording(timer):
            boxes, scores, classes = cls.collect(det, handle(*counters, *tallies))
        assert [len(b) for b in boxes] == [2, 1] and [len(s) for s in scores] == [2, 1]
        assert {k: n for k, n in timer.items.items() if n} == {name: 12 for name in cls._tallies}
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == len(words)
        for line, word, c in zip(lines, words, counters):
            assert line.startswith("WARNING: " + word) and " %d " % max(c) in line
        cls.collect(det, handle(*[[0, 0, 0]] * (len(counters) + len(tallies))))
        assert capsys.readouterr().out == ""
        with pytest.raises(ValueError):
            cls.collect(det, handle(*[[0, 0, 0]] * (len(counters) + len(tallies) + 1)))
