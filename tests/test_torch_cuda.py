"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips inside the test when
no CUDA device is present. The file imports neither JAX nor the JAX package,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the JAX package's
tests.) Tolerances are stated beside each comparison."""

import numpy as np
import pytest
import torch

from videotofaces_tpu_torch import config
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.models import yolo as TY
from videotofaces_tpu_torch.ops import crops_kernel as CK
from videotofaces_tpu_torch.ops import pnet_kernel as PK
from videotofaces_tpu_torch.ops import resize_kernel as RK
from videotofaces_tpu_torch.ops import roi_align as RA
from videotofaces_tpu_torch.ops import roi_align_kernel as RAK
from videotofaces_tpu_torch.ops.boxes import box_iou_matrix
from videotofaces_tpu_torch.utils.weights import unflatten

# float32: accumulation order only (fma chains in the kernel, cuDNN in the
# plain version). bfloat16: a one-ulp f32 difference can move a bf16-rounded
# map by one bf16 ulp, compounding through the four bf16-stored maps — the
# bounds the JAX package sets between two blockings of its own kernel
# (tests/test_models_mtcnn.py:699-706).
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-6),
        torch.bfloat16: dict(rtol=0.05, atol=5e-3)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _jax_shapes(model):
    """{"net/a/b/kernel": shape} of the JAX package's MTCNN parameter tree,
    read off the port's modules (OIHW -> HWIO, [out, in] -> [in, out])."""
    out = {}
    for net in ("pnet", "rnet", "onet"):
        for key, val in getattr(model, net).state_dict().items():
            parts, shape = [net] + key.split("."), tuple(val.shape)
            if parts[-1] == "weight":
                parts[-1] = "kernel"
                shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
            out["/".join(parts)] = shape
    return out


def _seeded_model(seed, cls_shift=2.0, reg_scale=1e-4):
    """MTCNN with numpy-seeded weights N(0, 0.25) (the recipe of the port's
    JAX-parity tests): large logits, so stage-1 probabilities spread far
    apart, and a face-logit shift so that every stage sees candidates."""
    flat = {}
    rng = np.random.default_rng(seed)
    for k, shape in sorted(_jax_shapes(TM.MTCNN()).items()):
        x = rng.normal(0.0, 0.25, shape).astype(np.float32)
        if k.endswith("alpha"):
            x = np.abs(x) * 0.5 + 0.1
        if "cls" in k and k.endswith("bias"):
            x = rng.normal(-0.4, 0.5, shape).astype(np.float32)
            x[1] += cls_shift
        if "reg" in k or "lmk" in k:
            x = x * reg_scale
        flat[k] = x
    return TM.MTCNN.from_jax(unflatten(flat)).eval()


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).cuda()


# The live cell's float32 geometry (batch 4 of 1080p, min face 5): the three
# upscaled levels, pooled inside the kernel, and the largest and the smallest
# of the 13 pre-pooled ones.
_CELL_LEVELS = [(2593, 4609), (1838, 3268), (1303, 2317), (924, 1643), (15, 27)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,level_hw",
                         [pytest.param(torch.float32, None, id="f32"),
                          pytest.param(torch.bfloat16, None, id="bf16")]
                         + [pytest.param(torch.float32, lv, id="f32-1080p-%dx%d" % lv)
                            for lv in _CELL_LEVELS])
def test_pnet_level_kernel_matches_plain(dtype, level_hw):
    _need_cuda()
    if level_hw is None:
        frames = _frames(2, 120, 200, 9)
        # upscaled (windows <= 2), downscaled, and the smallest level PNet takes
        levels = [(289, 481), (85, 141), (15, 27)]
    else:
        frames, levels = _frames(4, 1080, 1920, 9), [level_hw]
    w = PK.pack_weights(TM.MTCNN.seeded(0).pnet, dtype).cuda()
    for level_hw in levels:
        n0 = PK.pnet_level.launches
        reg, prob = PK.pnet_level(frames, level_hw, w, dtype)
        torch.cuda.synchronize()
        assert PK.pnet_level.launches == n0 + 1
        preg, pprob = PK.pnet_level_plain(frames, level_hw, w, dtype)
        assert reg.dtype == dtype and prob.dtype == torch.float32
        torch.testing.assert_close(prob, pprob, **TOLS[dtype])
        torch.testing.assert_close(reg.float(), preg.float(), **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pnet_level_kernel_tile_edges(dtype):
    """Levels at the tilings' edges (32 x 32 tiles in bf16, 16 x 32 in f32):
    PH or PW of 1, 31, 32 and 33, the smallest level, on odd frame sizes,
    pooled inside the kernel (upscaled) and beforehand (downscaled); in f32
    also PH of 15, 16, 17 against PW of 31 .. 33 and 63 .. 65. A level at
    half the frame has 2 px windows whose frame patch (444 bytes wide, 148
    rows a bf16 tile, 84 an f32 one) exceeds either kernel's shared-memory
    patch area, so it pools from device memory."""
    _need_cuda()
    w = PK.pack_weights(TM.MTCNN.seeded(0).pnet, dtype).cuda()
    cases = {(1, 30, 31): [(71, 73), (75, 74), (12, 75), (73, 12), (15, 27), (35, 33)],
             (2, 121, 203): [(291, 487), (85, 141), (15, 27), (12, 12)],
             (2, 148, 200): [(74, 100)]}
    if dtype == torch.float32:
        for levels in (cases[(1, 30, 31)], cases[(2, 121, 203)]):
            levels += [(39, 139), (41, 137), (43, 135), (39, 75), (41, 73), (43, 71)]
    for (b, h, wd), levels in cases.items():
        frames = _frames(b, h, wd, 10 + h)
        for level_hw in levels:
            reg, prob = PK.pnet_level(frames, level_hw, w, dtype)
            preg, pprob = PK.pnet_level_plain(frames, level_hw, w, dtype)
            torch.cuda.synchronize()
            assert reg.shape == preg.shape and prob.shape == pprob.shape
            tol = TOLS[dtype]
            torch.testing.assert_close(prob, pprob, **tol)
            amax = max(1.0, preg.float().abs().max().item())
            torch.testing.assert_close(reg.float(), preg.float(), rtol=tol["rtol"],
                                       atol=tol["atol"] * amax)


def _edge_slots(b, h, w, seed):
    """Slot rows at K3's edges: 1 x 1 windows, windows narrower than out
    (bins of 1-2 px), 1000 px windows, windows on the frame's last row and
    column and the whole frame, mixed with random ones and dead slots."""
    rng = np.random.default_rng(seed)
    rows = [[0, 0, 0, 1, 1, 1], [1, h - 1, w - 1, 1, 1, 1], [0, 5, 7, 3, 17, 1],
            [1, 100, 200, 23, 9, 1], [0, h - 1000, 1, 1000, 1000, 1],
            [1, 0, w - 1000, 1000, 997, 1], [0, h - 40, w - 33, 40, 33, 1],
            [1, 0, 0, h, w, 1], [0, h - 5, 0, 5, w, 1], [0, 3, 3, 30, 30, 0],
            [1, h - 10, w - 10, 11, 10, 1]]
    for _ in range(40):
        wh = int(rng.integers(1, h + 1))
        ww = int(rng.integers(1, w + 1))
        rows.append([int(rng.integers(0, b)), int(rng.integers(0, h - wh + 1)),
                     int(rng.integers(0, w - ww + 1)), wh, ww, int(rng.random() < 0.8)])
    return torch.tensor(rows, dtype=torch.int32).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("out", [24, 48])
@pytest.mark.parametrize("width", [1920, 1001], ids=["rows16", "rows_unaligned"])
def test_pool_crops_kernel_edges_exact(out, width):
    """Rows of 1920 px take the 16-byte path, rows of 1001 px the byte path;
    both equal the plain version exactly. An all-dead table is all zero."""
    _need_cuda()
    b, h = 2, 1080
    frames = _frames(b, h, width, 12)
    slots = _edge_slots(b, h, width, out)
    got = CK.pool_crops(frames, slots, out)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, CK.pool_crops_plain(frames, slots, out), rtol=0, atol=0)
    assert (got[9] == 0).all() and (got[1] != 0).any()
    dead = slots.clone()
    dead[:, 5] = 0
    n0 = CK.pool_crops.launches
    got = CK.pool_crops(frames, dead, out)
    torch.cuda.synchronize()
    assert CK.pool_crops.launches == n0 + 1 and (got == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("out", [24, 48])
def test_pool_crops_kernel_matches_plain_exactly(out):
    _need_cuda()
    rng = np.random.default_rng(2)
    b, h, w = 2, 360, 640
    frames = _frames(b, h, w, 3)
    n = 300
    wh, ww = rng.integers(1, h + 1, n), rng.integers(1, w + 1, n)
    scal = np.stack([rng.integers(0, b, n), rng.integers(0, h - wh + 1),
                     rng.integers(0, w - ww + 1), wh, ww,
                     (rng.random(n) < 0.8).astype(np.int64)], axis=1)
    scal[:5, 1] = h - 1     # windows running off the bottom edge: dead slots
    slots = torch.from_numpy(scal.astype(np.int32)).cuda()
    n0 = CK.pool_crops.launches
    got = CK.pool_crops(frames, slots, out)
    torch.cuda.synchronize()
    assert CK.pool_crops.launches == n0 + 1
    # exact int32 window sums and one IEEE division on both sides
    torch.testing.assert_close(got, CK.pool_crops_plain(frames, slots, out),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_pool_crops_empty_table_launches_nothing():
    """The launch count counts launches: an empty slot table launches no
    kernel and is not counted."""
    _need_cuda()
    frames = _frames(1, 40, 56, 4)
    n0 = CK.pool_crops.launches
    got = CK.pool_crops(frames, torch.zeros((0, 6), dtype=torch.int32, device="cuda"), 24)
    assert got.shape == (0, 24, 24, 3) and CK.pool_crops.launches == n0


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs_on_cuda():
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    falls back to the plain version."""
    _need_cuda()
    frames = _frames(1, 40, 56, 4)
    w = PK.pack_weights(TM.MTCNN.seeded(0).pnet, torch.float32)
    with pytest.raises(ValueError):
        PK.pnet_level(frames, (30, 40), w, torch.float32)          # weights on the CPU
    with pytest.raises(ValueError):
        PK.pnet_level(frames, (30, 40), w.cuda(), torch.float16)   # unsupported dtype
    slots = torch.zeros((4, 6), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        CK.pool_crops(frames, slots, 24)                           # int64 slots


@pytest.mark.cuda
def test_cascade_kernel_path_matches_plain_path():
    """The whole cascade in float32 / "highest": frames on the card (both
    kernels) against the same frames on the CPU (plain versions)."""
    _need_cuda()
    model = _seeded_model(1)
    frames = _frames(2, 180, 320, 5)
    caps = TM.Caps(pre1=256, post1=128, cross=512, stage2=256, stage3=64, out=32)
    n_p, n_c = PK.pnet_level.launches, CK.pool_crops.launches
    with config.precision_scope("highest"), torch.no_grad():
        got = TM.full_forward(model.cuda(), frames, minsize=12, caps=caps)
        want = TM.full_forward(model.cpu(), frames.cpu(), minsize=12, caps=caps)
    assert PK.pnet_level.launches > n_p and CK.pool_crops.launches == n_c + 2
    gv, wv = got[3].cpu(), want[3]
    assert gv.sum() > 0
    torch.testing.assert_close(gv.sum(1), wv.sum(1), rtol=0, atol=0)
    for i in range(gv.shape[0]):
        torch.testing.assert_close(got[1][i].cpu()[gv[i]], want[1][i][wv[i]],
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(got[0][i].cpu()[gv[i]], want[0][i][wv[i]],
                                   rtol=1e-3, atol=2e-2)


def _seeded_yolo(seed, reg_scale=0.1):
    """YOLOv3 with numpy-seeded weights, the recipe of the port's JAX-parity
    tests drawn in the port's key order: conv weights N(0, 1.6/fan_in) (the
    heads' regression rows x ``reg_scale``), BatchNorm scale 1 + N(0, 0.1)
    (0.2x on each residual block's second unit), var 0.8 + |N| * 0.2,
    biases and means N(0, 0.1)."""
    model = TY.YOLOv3()
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in model.state_dict().items():
        parts, shape = key.split("."), tuple(val.shape)
        if parts[-1] == "num_batches_tracked":
            sd[key] = val
            continue
        x = rng.normal(0.0, 1.0, shape)
        if parts[-1] == "weight" and len(shape) == 4:
            x *= np.sqrt(1.6 / np.prod(shape[1:]))
            if parts[-2].startswith("pred"):
                x[(np.arange(shape[0]) % 6) < 4] *= reg_scale
        elif parts[-1] == "running_var":
            x = np.abs(x) * 0.2 + 0.8
        elif parts[-1] == "weight":
            x = (0.2 if parts[-3] == "conv2" and "_res" in parts[-4] else 1.0) * (1.0 + 0.1 * x)
        else:
            x *= 0.1
        sd[key] = torch.from_numpy(x.astype(np.float32))
    model.load_state_dict(sd)
    return model.eval()


def _matched(a, b, iou=0.99):
    """Share of the boxes of ``a`` that a box of ``b`` overlaps at IoU >= iou."""
    if len(a) == 0:
        return 1.0
    return float((box_iou_matrix(a, b).max(1).values >= iou).float().mean()) if len(b) else 0.0


@pytest.mark.cuda
def test_yolo_card_matches_cpu():
    """YOLOv3's full forward in float32 / "highest" (no TF32) on the card
    (cuDNN) against the same model on the CPU: 2 frames of 180 x 320 at
    max_side 160 (canvas 96 x 160). The detections must match at IoU >=
    0.99 both ways, with scores within 1e-4 of the CPU's."""
    _need_cuda()
    model = _seeded_yolo(2)
    frames = _frames(2, 180, 320, 6)
    resized = TY.resized_shape(180, 320, 160)
    canvas = TY.canvas_shape(*resized)
    priors, strides = (torch.from_numpy(a) for a in TY.flat_priors_and_strides(canvas))
    with config.precision_scope("highest"), torch.no_grad():
        got = TY.full_forward(model.cuda(), frames, resized, canvas, priors.cuda(),
                              strides.cuda())
        want = TY.full_forward(model.cpu(), frames.cpu(), resized, canvas, priors, strides)
    assert got[4].tolist() == [0, 0] == want[4].tolist()
    for i in range(2):
        gv, wv = got[3][i].cpu(), want[3][i]
        gb, wb = got[0][i].cpu()[gv], want[0][i][wv]
        assert len(wb) > 5 and len(gb) == len(wb)
        assert _matched(gb, wb) == 1.0 and _matched(wb, gb) == 1.0
        torch.testing.assert_close(got[1][i].cpu()[gv], want[1][i][wv], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_face_service_card_matches_cpu():
    """``FaceService.extract`` with f32 YOLOv3 (``_seeded_yolo``'s weights,
    max_side 160) and the seeded FaceNet, precision "highest", on the card
    against the same service on the CPU, on 2 frames of 180 x 320: the same
    per-frame counts, every detection of each side matched by one of the
    other at IoU >= 0.99 (the nearest score among those), identical int
    boxes, scores within 1e-4 and embeddings within 1e-4 of the CPU's."""
    _need_cuda()
    from videotofaces_tpu_torch.serve import FaceService
    from videotofaces_tpu_torch.specs import BoxCriteria

    state = _seeded_yolo(2).state_dict()
    crit = BoxCriteria(min_score=0.0, min_size=1, min_border=0)
    frames = list(_frames(2, 180, 320, 6).cpu().numpy())
    out = {}
    for dev in ("cuda", "cpu"):
        svc = FaceService(device=dev, det_kw=dict(max_side=160), criteria=crit)
        svc.detector.model.load_state_dict(state)
        with config.precision_scope("highest"):
            out[dev] = svc.extract(frames)
    for g, w in zip(out["cuda"], out["cpu"], strict=True):
        assert len(w["boxes"]) > 5 and len(g["boxes"]) == len(w["boxes"])
        iou = box_iou_matrix(torch.from_numpy(g["boxes"]).float(),
                             torch.from_numpy(w["boxes"]).float()).numpy()
        near = np.abs(g["scores"][:, None] - w["scores"][None, :])
        gi = np.where(iou >= 0.99, near, np.inf).argmin(1)
        assert (iou.max(1) >= 0.99).all() and (iou.max(0) >= 0.99).all()
        np.testing.assert_array_equal(g["boxes"], w["boxes"][gi])
        np.testing.assert_allclose(g["scores"], w["scores"][gi], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["embeddings"], w["embeddings"][gi], rtol=0, atol=1e-4)


def _packed_crops(seed, shapes, max_size=256):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]
    packed, sizes = RK.pack_images(imgs, max_size)
    return torch.from_numpy(packed).cuda(), torch.from_numpy(sizes).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("out", [160, 128])
@pytest.mark.parametrize("swap_rb", [True, False], ids=["bgr2rgb", "noswap"])
def test_resize_normalize_kernel_matches_plain(out, swap_rb):
    _need_cuda()
    packed, sizes = _packed_crops(6, [(1, 1), (1, 57), (33, 1), (64, 64), (97, 211),
                                      (200, 150), (256, 256), (800, 600), (141, 180)])
    n0 = RK.resize_normalize.launches
    got = RK.resize_normalize(packed, sizes, out, 1 / 128.0, 127.5, swap_rb)
    torch.cuda.synchronize()
    assert RK.resize_normalize.launches == n0 + 1
    assert got.shape == (packed.shape[0], 3, out, out)
    # the same tap weights on both sides; the sums differ by FMA contraction
    torch.testing.assert_close(
        got, RK.resize_normalize_plain(packed, sizes, out, 1 / 128.0, 127.5, swap_rb),
        rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_resize_normalize_empty_batch_launches_nothing():
    _need_cuda()
    n0 = RK.resize_normalize.launches
    got = RK.resize_normalize(torch.zeros((0, 64, 64, 3), dtype=torch.uint8, device="cuda"),
                              torch.zeros((0, 2), dtype=torch.int32, device="cuda"),
                              160, 1 / 128.0, 127.5)
    assert got.shape == (0, 3, 160, 160) and RK.resize_normalize.launches == n0
    with pytest.raises(ValueError):       # int64 sizes
        RK.resize_normalize(torch.zeros((1, 64, 64, 3), dtype=torch.uint8, device="cuda"),
                            torch.ones((1, 2), dtype=torch.int64, device="cuda"), 160,
                            1 / 128.0, 127.5)


def _roi_inputs(seed, dtype, b=2, r=300, c=256):
    """A 4-level pyramid of a 192 x 336 canvas and a seeded roi mix: random
    boxes of every size, boxes on the level edges (sqrt(wh) of 112, 224,
    448), a 1:20 box (k > 8 samples per bin), boxes off the canvas, and
    about a tenth of the slots not valid."""
    rng = np.random.default_rng(seed)
    sizes = [(48, 84), (24, 42), (12, 21), (6, 11)]
    fmaps = [torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).cuda().to(dtype)
             for h, w in sizes]
    x1, y1 = rng.uniform(-20, 330, (b, r)), rng.uniform(-20, 190, (b, r))
    side = np.exp(rng.uniform(np.log(1), np.log(500), (b, r)))
    asp = np.exp(rng.normal(0, 0.6, (b, r)))
    boxes = np.stack([x1, y1, x1 + side * asp, y1 + side / asp], -1).astype(np.float32)
    boxes[0, :5] = [[0, 0, 112, 112], [10, 10, 234, 234], [0, 0, 448, 448],
                    [2, 20, 322, 36], [100, 50, 101, 51]]
    valid = rng.random((b, r)) >= 0.1
    return fmaps, torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_matches_plain(dtype, c):
    """K4 against the plain dense method on the same levels (bf16 levels are
    read as float32 by both): the weights are the same, and both take
    float32 sums of rows, then of columns, the kernel in fma chains and the
    plain version through cuBLAS, so they agree to float32 rounding: rtol
    1e-5, atol 1e-5 x max|feature|. C = 6 is no multiple of 4: the kernel
    then loads one channel at a time."""
    _need_cuda()
    fmaps, boxes, valid = _roi_inputs(7, dtype, c=c)
    n0 = RAK.roi_align_cuda.launches
    got, dropped, kept, truncated = RA.roi_align_fpn(fmaps, boxes, valid)
    torch.cuda.synchronize()
    assert RAK.roi_align_cuda.launches == n0 + 1
    assert got.shape == (2, 300, 7, 7, c) and got.dtype == torch.float32
    assert dropped.tolist() == [0, 0] and truncated.tolist() == [0, 0]
    assert torch.equal(kept, valid)
    want = RA.roi_align_fpn_plain(fmaps, boxes, valid)
    amax = max(float(f.float().abs().max()) for f in fmaps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * amax)
    assert (got[~valid] == 0).all()
    assert RA.assign_fpn_levels(boxes[0, :3]).tolist() == [1, 2, 3]


@pytest.mark.cuda
def test_roi_align_kernel_all_invalid_and_empty():
    """Slots that are not valid come out zero (one launch), from float32 and
    bfloat16 levels; an empty roi table launches nothing and is not
    counted."""
    _need_cuda()
    for dtype in (torch.float32, torch.bfloat16):
        fmaps, boxes, valid = _roi_inputs(8, dtype, r=40)
        n0 = RAK.roi_align_cuda.launches
        got = RA.roi_align_fpn(fmaps, boxes, torch.zeros_like(valid))[0]
        torch.cuda.synchronize()
        assert RAK.roi_align_cuda.launches == n0 + 1 and (got == 0).all()
    empty = RA.roi_align_fpn(fmaps, boxes[:, :0].contiguous(), valid[:, :0].contiguous())[0]
    assert empty.shape == (2, 0, 7, 7, 256) and RAK.roi_align_cuda.launches == n0 + 1
    lv = RA.assign_fpn_levels(boxes).to(torch.int32)
    with pytest.raises(ValueError):                     # int64 levels
        RAK.roi_align_cuda(fmaps, boxes, lv.long(), valid, RA.STRIDES)
    with pytest.raises(ValueError):                     # NCHW-strided level
        RAK.roi_align_cuda([fmaps[0].permute(0, 3, 1, 2).permute(0, 2, 3, 1)[:, :, ::2]]
                           + fmaps[1:], boxes, lv, valid, RA.STRIDES)
    with pytest.raises(ValueError):                     # float16 levels
        RAK.roi_align_cuda([f.half() for f in fmaps], boxes, lv, valid, RA.STRIDES)


def _one_hot_levels(rng, b, sizes, c, dtype):
    """Levels whose channel c is 1.0 at one seeded pixel (y_c, x_c) of each
    image and 0 elsewhere: a pooled value is then one weight product."""
    out = []
    for h, w in sizes:
        f = np.zeros((b, h, w, c), np.float32)
        for img in range(b):
            f[img, rng.integers(0, h, c), rng.integers(0, w, c), np.arange(c)] = 1.0
        out.append(torch.from_numpy(f).cuda().to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_weight_tables_exact(dtype):
    """One-hot levels pin the kernel's weight tables: out[i, j, c] =
    wy[i, y_c] * wx[j, x_c], one rounding on both sides, so the kernel
    equals the plain version (weights of _axis_weights; TF32 off) exactly."""
    _need_cuda()
    rng = np.random.default_rng(11)
    _, boxes, valid = _roi_inputs(11, dtype)
    fmaps = _one_hot_levels(rng, 2, [(48, 84), (24, 42), (12, 21), (6, 11)], 256, dtype)
    got = RA.roi_align_fpn(fmaps, boxes, valid)[0]
    with config.precision_scope("highest"):
        want = RA.roi_align_fpn_plain(fmaps, boxes, valid)
    torch.cuda.synchronize()
    assert int((want != 0).sum()) > 10000          # many one-hot pixels fall in windows
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _ulps(v, n):
    """The float32 n ulps from v (below for n < 0)."""
    x = np.float32(v)
    for _ in range(abs(n)):
        x = np.nextafter(x, np.float32(np.sign(n) * 1e9))
    return float(x)


# boxes [R, 4] on a 768 x 1344 canvas (P2 192 x 336 .. P5 24 x 42), one
# table per case; both images carry it
_ROI_CASES = {
    # hundreds of columns on P2, k = 48 > 8 samples per bin along x; the
    # transposed box, k = 28 along y
    "long_1333x5": [[5, 100, 1338, 105], [100, 5, 105, 763]],
    "1px": [[700, 500, 701, 501], [0, 0, 1, 1], [1343, 767, 1344, 768]],
    # samples below -1 and past S; the third box lies wholly left of the
    # canvas, the fourth wholly above it
    "off_canvas": [[-100, -50, 60, 40], [1300, 700, 1500, 900], [-400, 300, -10, 500],
                   [1200, -300, 1400, -50]],
    # samples reach the last row and column (weight 1 there)
    "clamp": [[1200, 650, 1344, 768], [1000, 600, 1344, 768], [0, 0, 1344, 768]],
    # sqrt(wh) from three float32 ulps below to one above 112, 224 and 448:
    # the level moves up at 112 and 224 less one ulp, 448 less two
    "level_edges": [[0.0, 0.0, _ulps(v, n), _ulps(v, n)]
                    for v in (112.0, 224.0, 448.0) for n in (-3, -2, -1, 0, 1)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_ROI_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_edge_cases(case, dtype):
    """K4 against the plain version on rois at the edges of the function's
    domain, at the tolerance of test_roi_align_kernel_matches_plain."""
    _need_cuda()
    rng = np.random.default_rng(12)
    c = 256
    fmaps = [torch.from_numpy(rng.normal(0, 1, (2, h, w, c)).astype(np.float32)).cuda().to(dtype)
             for h, w in [(192, 336), (96, 168), (48, 84), (24, 42)]]
    boxes = torch.tensor(_ROI_CASES[case], dtype=torch.float32).cuda()
    boxes = boxes[None].repeat(2, 1, 1).contiguous()
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device="cuda")
    n0 = RAK.roi_align_cuda.launches
    got = RA.roi_align_fpn(fmaps, boxes, valid)[0]
    want = RA.roi_align_fpn_plain(fmaps, boxes, valid)
    torch.cuda.synchronize()
    assert RAK.roi_align_cuda.launches == n0 + 1
    amax = max(float(f.float().abs().max()) for f in fmaps)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * amax)
    if case == "level_edges":
        assert RA.assign_fpn_levels(boxes[0]).view(3, 5).tolist() == [
            [0, 0, 1, 1, 1], [1, 1, 2, 2, 2], [2, 3, 3, 3, 3]]
    else:
        assert (got != 0).any()


# -- training steps: the card against the CPU (chip_smoke.py 4r-4t) ------------
# chip_smoke.card_vs_cpu_step runs one step on each in precision "highest" and
# holds the card to the CPU at the tolerances of the CPU parity tests
# (chip_smoke.check_grads / check_params): loss rtol 1e-5, gradients rtol
# 1e-4 and 1e-5 x the tensor's max (1e-4 for FaceNet, as in its CPU test),
# parameters 1e-5 relative.


@pytest.mark.cuda
def test_yolo_full_step_card_matches_cpu():
    _need_cuda()
    import chip_smoke as CS
    from videotofaces_tpu_torch.train import detector as TD

    params = CS.yolo_params(0)
    frames, gts = CS.small_faces(5, 2)
    priors, strides = TY.flat_priors_and_strides((64, 64))
    canvas, obj_t, box_t = TD._prepare_yolo_data(frames, gts, priors, 0.5, 0.4, 64, 64, 64, 64)
    batch = [torch.from_numpy(canvas).permute(0, 3, 1, 2).contiguous()] + [
        torch.from_numpy(a) for a in (obj_t, box_t, priors, strides)]
    scales = {"backbone": 0.1, "neck": 0.3, "head": 1.0}
    _, norm, _ = CS.card_vs_cpu_step(
        torch.device("cuda"), lambda: TY.YOLOv3.from_jax(params),
        lambda m: TD.layerwise_tx(m, 1e-3), TD.train_step_full, batch, 1e-3,
        lambda k: 0.0 if TD._is_bn_stat(k) else scales[k.split(".")[0]])
    assert norm > 1.0                   # the clip acts


@pytest.mark.cuda
def test_triplet_step_card_matches_cpu():
    _need_cuda()
    import chip_smoke as CS
    from videotofaces_tpu_torch.models import facenet as TF
    from videotofaces_tpu_torch.train import triplet as TT
    from videotofaces_tpu_torch.train.optim import AdamW, leaves

    crops, _ = CS.identity_crops(9, 8, 1, 75)
    x = TF.preprocess_uint8(torch.from_numpy(np.ascontiguousarray(crops[..., ::-1])))
    batch = [x.permute(0, 3, 1, 2).contiguous(), torch.arange(8) // 2]
    tree = CS.calibrated_head_bn(CS.facenet_params(3), batch[0])
    # the CPU takes the card's ReLU masks and max-pool argmaxes, as in
    # chip_smoke.py 4s: a value within float32 rounding of a branch point can
    # take another branch on each device and move a gradient by a position's
    # share
    loss, _, _ = CS.card_vs_cpu_step(
        torch.device("cuda"), lambda: TF.InceptionResnetV1.from_jax(tree),
        lambda m: AdamW(leaves(m), 1e-5), TT.train_step, batch, 1e-5, grad_share=1e-4,
        routing=CS.FaceNetRouting())
    assert loss > 0.0


@pytest.mark.cuda
def test_classifier_step_card_matches_cpu():
    _need_cuda()
    import chip_smoke as CS
    from videotofaces_tpu_torch.train import trainer as TR

    small = dict(img_size=32, patch_size=16, dim=64, depth=2)
    gen = torch.Generator().manual_seed(6)
    batch = [torch.randn((8, 3, 32, 32), generator=gen),
             torch.randint(0, 5, (8,), generator=gen)]
    for remat in (False, True):
        CS.card_vs_cpu_step(
            torch.device("cuda"), lambda: TR.ViTClassifier.seeded(5, seed=1, remat=remat, **small),
            lambda m: TR.create_train_state(m, 1e-3), TR.train_step, batch, 1e-3,
            zero=("attn.k.bias",))


def _need_cards(n):
    _need_cuda()
    if torch.cuda.device_count() < n:
        pytest.skip("needs %d CUDA devices, this host has %d" % (n, torch.cuda.device_count()))


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")],
                         ids=["two_shards_one_card", "two_cards"])
def test_sharded_wrappers_and_ops_equal_one_device(devices):
    """``chip_smoke.sharded_vs_single`` (phases 4u and 4v) at a small size:
    MTCNN and Faster R-CNN in bf16 on 2 frames of 360 x 640, FaceNet
    through K5 on 16 crops, dedup / K-means / silhouette on 512 x 512, each
    sharded over ``devices`` against ``mesh=None``: detections matched at
    IoU >= 0.99 with equal counts, embeddings within 1e-4, the ops at
    tests/test_parallel.py's tolerances, and every kernel launched once per
    shard for each launch of the single-device call."""
    _need_cards(len(set(devices)))
    import chip_smoke as CS

    CS.sharded_vs_single(list(devices), CS.seeded_frames(7, b=2, h=360, w=640),
                         CS.encoder_crops(4, 16), CS.unit_blobs(6, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("devices,grids", [(("cuda:0",) * 4, ((2, 2), (2, 1))),
                                           (("cuda:0", "cuda:1"), ((2, 1), (1, 2)))],
                         ids=["one_card", "two_cards"])
def test_sharded_training_steps_equal_one_device(devices, grids):
    """``chip_smoke.train_sharded`` (phase 4y) at a small size: the
    classifier's step (img 32, dim 128, depth 2, batch 8) on each grid, the
    YOLOv3 full / head steps (64 px, batch 4) and the FaceNet triplet /
    bank steps (75 px, batch 8) on the ``"model"``-size-1 grids, each held
    in "highest" to the same step with ``mesh=None`` on the first card
    (loss, aux, embeddings, every updated leaf, at the tolerances stated
    in chip_smoke.py); the three loops with ``mesh=`` on one card; no
    hand-written kernel launched."""
    _need_cards(len(set(devices)))
    import chip_smoke as CS

    CS.train_sharded(list(devices), list(grids), small=True, loops=len(set(devices)) == 1)


@pytest.mark.cuda
def test_kernels_follow_the_tensors_device():
    """Every kernel on cuda:1 called while the thread's current device is
    cuda:0 equals its plain version, and a detector on cuda:1 equals the
    same detector on cuda:0 (``chip_smoke.other_device_calls``)."""
    _need_cards(2)
    import chip_smoke as CS

    CS.other_device_calls(CS.seeded_frames(7, b=2, h=360, w=640))


_MH_HOST = r"""
import hashlib, os, sys
sys.path.insert(0, ".")
import numpy as np, torch
from videotofaces_tpu_torch.ops import cluster_scores as CS
from videotofaces_tpu_torch.ops import distances as D
from videotofaces_tpu_torch.ops.kmeans import kmeans_fit
from videotofaces_tpu_torch.parallel import multihost as MH
if os.environ.get("GLOO_INIT"):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + os.environ["GLOO_INIT"],
                            rank=int(os.environ["RANK_"]), world_size=2)
x = np.random.default_rng(0).normal(size=(2048, 512)).astype(np.float32)
x /= np.linalg.norm(x, axis=1, keepdims=True)
mins, inds = D.dedup_cosine(torch.from_numpy(x).to("cuda:0"))
labels, centers, inertia = kmeans_fit(x, 8, device="cuda:0")
sil = CS.silhouette_score(x, labels, 8, device="cuda:0")
h = hashlib.sha256()
for a in (mins.cpu().numpy(), inds.cpu().numpy(), labels, centers, np.float64(inertia),
          np.float64(sil)):
    h.update(np.ascontiguousarray(a).tobytes())
rows, names = MH.allgather_rows(np.frombuffer(h.digest(), np.uint8)[None],
                                 ["host%d" % MH.process_info()[0]])
assert rows.shape == (2, 32) and names == ["host0", "host1"], (rows.shape, names)
assert (rows[0] == rows[1]).all(), "the two processes' grouping ops differ"
if os.environ.get("GLOO_INIT"):
    dist.barrier()
    dist.destroy_process_group()
print("OK", h.hexdigest()[:16])
"""


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["dir", "gloo"])
def test_two_processes_on_one_card_gather_and_agree(transport, tmp_path):
    """Two host processes on cuda:0 all-gather through the shared gather
    directory or a gloo group, and compute the embedding dedup, K-means and
    silhouette bit for bit alike (what every host of a multi-host job
    relies on)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    _need_cuda()
    root = Path(__file__).resolve().parents[1]
    procs = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith("V2F_")}
        if transport == "dir":
            env.update(V2F_PROCESS_INDEX=str(i), V2F_PROCESS_COUNT="2",
                       V2F_GATHER_DIR=str(tmp_path), V2F_RUN_ID="card")
        else:
            env.update(GLOO_INIT=str(tmp_path / "init"), RANK_=str(i))
        procs.append(subprocess.Popen([sys.executable, "-c", _MH_HOST], cwd=str(root), env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    digests = [o.strip().splitlines()[-1] for o in outs]
    assert digests[0] == digests[1] and digests[0].startswith("OK"), digests
