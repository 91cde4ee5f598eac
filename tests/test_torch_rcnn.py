"""The port's Faster R-CNN (ResNet-50 + FPN + RPN + RoI head) and
``FrcnnDetector`` against the JAX package's, jitted, on the same
numpy-seeded parameters converted by ``utils.weights.frcnn_from_jax``.

Also home of ``jax_frcnn_params``, the parameter tree the port's anime-path
tests feed to both packages."""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu import config as jconfig
from videotofaces_tpu.models import rcnn as JR
from videotofaces_tpu.models import resnet as JRES
from videotofaces_tpu.models.wrappers import FrcnnDetector as JaxDetector
from videotofaces_tpu.ops.anchors import get_priors
from videotofaces_tpu_torch import config
from videotofaces_tpu_torch.models import rcnn as TR
from videotofaces_tpu_torch.models import resnet as TRES
from videotofaces_tpu_torch.models.wrappers import FrcnnDetector
from videotofaces_tpu_torch.ops.boxes import box_iou_matrix
from videotofaces_tpu_torch.utils.weights import frcnn_from_jax

from test_torch_facenet import few_threads  # noqa: F401

CANVAS = (64, 96)
KW = dict(resized_hw=CANVAS, canvas_hw=CANVAS, proposal_cap=64, out_top=64)
# float32 on both sides, different convolution algorithms through ~60 layers
MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=0, atol=1e-3)            # pixels
SCORE_TOL = dict(rtol=0, atol=1e-5)
# bfloat16: the two packages round their convolutions' outputs at other
# places, so a few near-tied proposals and NMS decisions flip; a detection
# matches when a detection of the other side overlaps it at IoU >= 0.99
BF16_IOU, BF16_MATCHED = 0.99, 0.85


@functools.lru_cache(maxsize=1)
def _jax_frcnn_shapes():
    return {"body": jax.eval_shape(JR.FasterRCNN(1).init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 96, 3)))["params"],
            "head": jax.eval_shape(JR.RoIHead(1).init, jax.random.PRNGKey(1),
                                   jnp.zeros((1, 7, 7, 256)))["params"]}


def jax_frcnn_params(seed=0, cls_shift=1.0):
    """Faster R-CNN {"body", "head"} tree in the JAX layout, drawn with numpy:
    kernels N(0, 1/fan_in) (the regression heads' x 0.1, so that boxes stay
    near their anchors and proposals), BatchNorm scale 1 + N(0, 0.1) (0.2x
    on each bottleneck's last unit, so that the residual stream does not
    blow up), var 0.8 + |N| * 0.2, biases and means N(0, 0.1), and the RoI
    head's face logit shifted by ``cls_shift`` so that detections pass the
    score threshold."""
    rng = np.random.default_rng(seed)

    def rnd(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        name = keys[-1]
        x = rng.normal(0.0, 1.0, a.shape).astype(np.float32)
        if name == "kernel":
            x *= np.float32(np.sqrt(1.0 / np.prod(a.shape[:-1])))
            if keys[-2] == "reg":
                x *= np.float32(0.1)
        elif name == "var":
            x = np.abs(x) * 0.2 + 0.8
        elif name == "scale":
            x = (0.2 if "u3" in keys else 1.0) * (1.0 + 0.1 * x)
        else:                                         # bias, mean
            x *= np.float32(0.1)
        if keys[0] == "head" and keys[-2] == "cls" and name == "bias":
            x[0] += cls_shift
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(rnd, _jax_frcnn_shapes())


def smooth_frames(seed, n, h=64, w=96):
    rng = np.random.default_rng(seed)
    return np.stack([cv2.resize(rng.integers(0, 256, (8, 12, 3)).astype(np.uint8), (w, h),
                                interpolation=cv2.INTER_CUBIC) for _ in range(n)])


def _priors(canvas=CANVAS):
    return get_priors(canvas, JR.frcnn_bases(), loc="corner", concat=False)


@pytest.fixture(scope="module")
def params():
    return jax_frcnn_params(0)


@pytest.fixture(scope="module")
def model(params):
    return TR.AnimeFRCNN.from_jax(params).eval()


def test_frcnn_from_jax_layout(params, model):
    sd = frcnn_from_jax(params)
    b = params["body"]
    np.testing.assert_array_equal(
        sd["body"]["backbone.layer2_block0.u2.conv.weight"].numpy(),
        b["ResNet_0"]["layer2_block0"]["u2"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["body"]["backbone.stem.bn.running_var"].numpy(),
                                  b["ResNet_0"]["stem"]["bn"]["var"])
    np.testing.assert_array_equal(sd["body"]["fpn.lateral3.conv.bias"].numpy(),
                                  b["fpn"]["lateral3"]["conv"]["bias"])
    np.testing.assert_array_equal(sd["body"]["rpn.reg.weight"].numpy(),
                                  b["rpn"]["reg"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head"]["fc0.weight"].numpy(),
                                  params["head"]["fc0"]["kernel"].T)
    assert set(sd["body"]) == set(model.body.state_dict())
    assert set(sd["head"]) == set(model.head.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_stats = sum(a.size for path, a in leaves if path[-1].key in ("mean", "var"))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for _, a in leaves) - n_stats


def test_resnet_small_matches_flax():
    net = JRES.ResNet(block_counts=(1, 1, 1, 1))
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(2)

    def rnd(path, a):
        name = path[-1].key
        if name == "var":
            return (np.abs(rng.normal(0, 0.2, a.shape)) + 0.8).astype(np.float32)
        sd = np.sqrt(1.0 / np.prod(a.shape[:-1])) if name == "kernel" else 0.1
        return rng.normal(1.0 if name == "scale" else 0.0, sd, a.shape).astype(np.float32)

    p = jax.tree_util.tree_map_with_path(rnd, shapes)
    want = jax.jit(net.apply)({"params": p}, x)
    port = TRES.ResNet((1, 1, 1, 1)).eval()
    sd = frcnn_from_jax({"body": {"ResNet_0": p}, "head": {}})["body"]
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[1:]) for g in got] == [(256, 16, 16), (512, 8, 8), (1024, 4, 4),
                                                 (2048, 2, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **MAP_TOL)


def test_fpn_rpn_and_head_match_flax(params, model):
    rng = np.random.default_rng(3)
    feats = [rng.normal(0, 1, (2, 16 // 2 ** i, 24 // 2 ** i, c)).astype(np.float32)
             for i, c in enumerate((256, 512, 1024, 2048))]
    pyr = jax.jit(lambda fs: JR.FPN().apply({"params": params["body"]["fpn"]}, fs))(feats)
    regs, logs = jax.jit(lambda ps: JR.RPNHead().apply({"params": params["body"]["rpn"]},
                                                       ps))(pyr)
    with torch.no_grad():
        tpyr = model.body.fpn([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
        tregs, tlogs = model.body.rpn(tpyr)
    assert len(tpyr) == 5 and tuple(tpyr[4].shape[2:]) == (1, 2)
    for g, w in zip(tpyr, pyr):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **MAP_TOL)
    for g, w in zip(tregs + tlogs, list(regs) + list(logs)):    # anchor order (h, w, a)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MAP_TOL)
    maps = rng.normal(0, 1, (5, 7, 7, 256)).astype(np.float32)
    reg, cls = jax.jit(lambda m: JR.RoIHead(1).apply({"params": params["head"]}, m))(maps)
    with torch.no_grad():
        treg, tcls = model.head(torch.from_numpy(maps))
    np.testing.assert_allclose(treg.numpy(), np.asarray(reg), **MAP_TOL)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(cls), **MAP_TOL)


def _rpn_inputs(canvas, seed, b=2):
    rng = np.random.default_rng(seed)
    priors = _priors(canvas)
    regs = [rng.normal(0, 0.2, (b, p.shape[0], 4)).astype(np.float32) for p in priors]
    logs = [rng.normal(-1, 1.5, (b, p.shape[0])).astype(np.float32) for p in priors]
    return regs, logs, priors


@pytest.mark.parametrize("precision,canvas,lvtop,out_top", [
    ("highest", (64, 96), 50, 40),
    # lvtop > 256: the two-pass NMS (every level here has <= 4 * lvtop
    # anchors, so the JAX package selects exactly too)
    ("default", (64, 64), 300, 200),
])
def test_rpn_proposals_match_jax(precision, canvas, lvtop, out_top):
    regs, logs, priors = _rpn_inputs(canvas, 4)
    used = np.asarray([[canvas[0] - 4.0, canvas[1] * 1.0], [canvas[0] * 1.0, canvas[1] - 6.0]],
                      np.float32)
    with jconfig.precision_scope(precision):
        wb, wv, wo = (np.asarray(a) for a in jax.jit(lambda rg, lg: JR.rpn_proposals(
            rg, lg, [jnp.asarray(p) for p in priors], jnp.asarray(used), lvtop=lvtop,
            out_top=out_top))(regs, logs))
    with config.precision_scope(precision):
        gb, gv, go = TR.rpn_proposals([torch.from_numpy(r) for r in regs],
                                      [torch.from_numpy(lg) for lg in logs],
                                      [torch.from_numpy(p) for p in priors],
                                      torch.from_numpy(used), lvtop=lvtop, out_top=out_top)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(go.numpy(), wo)
    np.testing.assert_allclose(gb.numpy()[wv], wb[wv], rtol=1e-6, atol=1e-4)
    assert wv.sum() > 0


def test_rpn_two_pass_nms_counts_displacement():
    """More than 256 disjoint candidates on one level: the "default" two-pass
    NMS keeps the exact head and counts every dropped candidate; "highest"
    keeps them all."""
    n = 400
    g = int(np.ceil(np.sqrt(n)))
    cx = (np.arange(n) % g) * 20.0 + 10.0
    cy = (np.arange(n) // g) * 20.0 + 10.0
    priors = [torch.from_numpy(np.stack([cx, cy, np.full(n, 8.0), np.full(n, 8.0)],
                                        1).astype(np.float32))]
    regs = [torch.zeros((1, n, 4))]
    logs = [torch.linspace(3.0, 1.0, n)[None]]
    used = torch.tensor([[1e4, 1e4]])
    with config.precision_scope("default"):
        _, valid, overflow = TR.rpn_proposals(regs, logs, priors, used, lvtop=n, out_top=n)
    assert int(valid.sum()) == 256 and int(overflow[0]) == n - 256
    with config.precision_scope("highest"):
        _, valid, overflow = TR.rpn_proposals(regs, logs, priors, used, lvtop=n, out_top=n)
    assert int(valid.sum()) == n and int(overflow[0]) == 0


def _jax_full_forward(params, frames, **kw):
    priors = [jnp.asarray(p) for p in _priors()]
    fn = jax.jit(lambda p, x: JR.full_forward(p, x, priors_per_level=priors, **KW, **kw))
    return [np.asarray(a) for a in fn(params, jnp.asarray(frames))]


def _port_full_forward(model, frames, **kw):
    priors = [torch.from_numpy(p) for p in _priors()]
    with torch.no_grad():
        out = TR.full_forward(model, torch.from_numpy(frames), CANVAS, CANVAS, priors,
                              proposal_cap=KW["proposal_cap"], out_top=KW["out_top"], **kw)
    return [t.float().numpy() if t.is_floating_point() else t.numpy() for t in out]


def test_full_forward_highest_matches_jax(params, model):
    frames = smooth_frames(1, 2)
    with jconfig.precision_scope("highest"):
        want = _jax_full_forward(params, frames)
    with config.precision_scope("highest"):
        got = _port_full_forward(model, frames)
    assert len(got) == 7
    v = want[3]
    np.testing.assert_array_equal(got[3].sum(1), v.sum(1))
    assert v.sum(1).min() > 5, "too few detections — reseed the test"
    np.testing.assert_array_equal(got[3], v)
    np.testing.assert_allclose(got[0][v], want[0][v], **BOX_TOL)
    np.testing.assert_allclose(got[1][v], want[1][v], **SCORE_TOL)
    np.testing.assert_array_equal(got[2][v], want[2][v])
    for k in (4, 5, 6):
        assert got[k].tolist() == [0, 0] == want[k].tolist()


def _matched(a, b):
    """Share of the boxes of ``a`` that a box of ``b`` overlaps at IoU >=
    BF16_IOU."""
    if len(a) == 0:
        return 1.0
    iou = box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return float((iou.max(1) >= BF16_IOU).mean()) if len(b) else 0.0


def test_full_forward_bf16_close_to_pallas_interpret(params):
    """bf16 throughput mode (uint8-canvas preprocess, bf16 network, RoIAlign
    on bf16 levels) against the JAX package's bf16 graph with its Pallas
    RoIAlign in interpret mode."""
    frames = smooth_frames(1, 2)
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    with jconfig.precision_scope("default"):
        want = _jax_full_forward(p16, frames, compute_dtype=jnp.bfloat16,
                                 roi_method="pallas-interpret")
    m16 = TR.AnimeFRCNN.from_jax(params).to(torch.bfloat16).eval()
    with config.precision_scope("default"):
        got = _port_full_forward(m16, frames, compute_dtype=torch.bfloat16)
    for i in range(2):
        wb, gb = want[0][i][want[3][i]], got[0][i][got[3][i]]
        assert len(wb) > 5
        assert abs(len(gb) - len(wb)) <= (1 - BF16_MATCHED) * len(wb)
        assert _matched(wb, gb) >= BF16_MATCHED and _matched(gb, wb) >= BF16_MATCHED


@pytest.mark.parametrize("host_resize", [False, True], ids=["device_resize", "host_resize"])
def test_detector_matches_jax(params, host_resize):
    """``FrcnnDetector`` submit / collect on 48 x 72 frames resized to the
    64 x 96 canvas (on the host with cv2, or by the matrix resize), a batch
    of 3 padded to 4, in "highest"."""
    frames = list(smooth_frames(2, 3, 48, 72))
    kw = dict(params=params, batch_size=4, resize_spec=CANVAS, proposal_cap=64,
              out_top=20, host_resize=host_resize)
    with jconfig.precision_scope("highest"):
        want = JaxDetector(**kw)(frames)
    det = FrcnnDetector(device="cpu", roi_method="pallas", **kw)
    with config.precision_scope("highest"):
        got = det.collect(det.submit(frames))
    assert det.device.type == "cpu"
    for g, w in zip(got, want):          # boxes, scores, classes
        assert len(g) == len(w) == 3
        for gi, wi in zip(g, w):
            assert gi.shape == wi.shape
            np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-3)
    assert sum(len(b) for b in want[0]) > 0


def test_detector_refuses_unknown_roi_method():
    with pytest.raises(ValueError, match="roi_method"):
        FrcnnDetector(device="cpu", params=jax_frcnn_params(0), roi_method="fast")
