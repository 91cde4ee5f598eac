#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``videotofaces_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which must pass (the script runs them all, then exits 1 if
any failed, printing no result line):

1. the card: name, count, and ``nvidia-smi`` name + power limit;
2. build every CUDA kernel of the path from ``videotofaces_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), print each kernel's registers,
   shared memory and spills (``-Xptxas -v``) and count the tensor-core
   instructions in the PNet kernels' SASS (``cuobjdump -sass``; the bf16
   kernel must hold some);
3. each kernel at main-path shapes, held against its plain PyTorch version
   on the same inputs and timed with CUDA events: ``pnet_level`` over the
   whole 16-level pyramid of a batch of 2 1080p frames at min face 5 in
   bf16 plus two levels in f32, ``pool_crops`` at the stage-2 (2048 x 24 px)
   and stage-3 (512 x 48 px) slot tables, ``resize_normalize`` (K5) on 128
   packed crops to 160 px (beside a per-image ``F.interpolate`` loop, the
   nearest library computation) and to 128 px with the ViT affine,
   ``roi_align`` (K4) on a 1080p pyramid of the seeded R-CNN at batch 2 with
   its 1,000 RPN proposals per image and synthetic boxes (level edges, a 1:20
   box), in f32 and bf16;
4. the main paths through the user entry points, each with every launch
   count set to 0 just before it and read just after:
   a. ``MtcnnDetector(params=seeded, bf16=True)``, precision "default", on
      two seeded 1080p frames (ms per batch, counts, device busy share);
   b. the same cascade in f32 / "highest", kernel path against plain path
      on the card: equal valid counts, boxes and scores within tolerance;
   c. ``video_to_faces(mode="detection", style="live", det_model="mtcnn")``
      on a synthetic 1080p video (frames/s, stage timings);
   d. ``FaceNetEncoder(batch_size=128)``, precision "default", on 1,024
      seeded crops through the host-cv2 path and the ``device_resize=True``
      path (faces/s of each, their embeddings' difference, K5 launches =
      batches, device busy share of one batch);
   e. ``kmeans_fit`` and the three cluster scores on the card for k = 2..9
      on 4,096 seeded 512-d embeddings, labels equal to a CPU run;
   f. the full path by stages on a synthetic 1080p video: seeded MTCNN ->
      ``detect_faces`` -> ``get_encoder_model(..., device_resize=True)`` ->
      ``encode_faces`` -> embedding dedup -> ``cluster_faces`` (faces
      survive, group folders exist, all three kernels launched);
   g. ``video_to_faces(mode="full", style="live", det_model="mtcnn")`` with
      its defaults;
   h. ``FrcnnDetector(params=seeded, bf16=True)``, precision "default", on
      two seeded 1080p frames (ms per batch, K4 launches = batches, device
      busy share);
   i. the f32 detector in "highest", kernel path against plain RoIAlign on
      the card: equal detection counts, boxes and scores within tolerance;
   j. ``VitEncoder`` (B16, batch 128), precision "default", on 1,024 crops
      through the host-cv2 path and the ``device_resize=True`` path (K5 at
      out 128);
   k. ``video_to_faces(input_path, out_dir)`` with every other argument at
      its default — the anime path: Faster R-CNN, ViT-B16, embedding dedup,
      K-means, with the seeded random weights of a missing checkpoint, which
      find faces in 1080p frames — on a synthetic 1080p video (K4 launches);
   l. ``YoloDetector(params=seeded, bf16=True)``, precision "default", on
      two seeded 1080p frames (canvas 352 x 608): ms per batch, the valid
      candidates entering NMS per image, device busy share and time by
      kernel; once with the seeded weights (every candidate passes the
      thresholds: the worst case) and once with ``bench.py::_sparsify``'s
      recipe (objectness biases -4);
   m. ``YoloDetector`` f32 "highest" on the card against the same detector
      on the CPU at ``max_side`` 320: detections matched at IoU >= 0.99;
   n. ``video_to_faces(input_path, out_dir, style="live")`` with its
      defaults — YOLOv3 (seeded, face biases +2, through the factory),
      FaceNet-VGG (seeded, calibrated), hash and embedding dedup, K-means —
      on a synthetic 1080p video (wall time, stage timings);
   o. the serving path (``videotofaces_tpu_torch/serve.py``) with the anime
      defaults, ``FaceService(style="anime", enc_kw={"device_resize":
      True})`` (the seeded R-CNN recipe), behind the binary daemon on TCP
      in a thread: ``warmup`` timed, then ping, 5 x detect and 5 x extract
      of two seeded 1080p frames, 5 x embed of 16 crops, stats, shutdown
      through ``ServeClient`` — ms per request beside the direct call, the
      first request after warmup against the steady state, every reply
      equal to the direct call, K4 and K5 launched; then the CLI daemon's
      cold start in a fresh process, and K5's profiler kernel time at out
      160 and 128;
   p. the MTCNN cascade (bf16) + FaceNet (``device_resize``) behind the
      HTTP gateway with PNG-encoded 1080p frames: /detect and /extract
      equal to the direct call, ms per request split into the PNG codec
      and the service, K1-K3 and K5 launched;
   q. the live defaults (YOLOv3 + FaceNet) on a unix socket: 4 client
      threads x 3 extract requests at once beside one in-process caller
      holding precision "highest"; every reply equals the serial direct
      call of its thread's precision;
   r. training (``videotofaces_tpu_torch/train``): ``finetune_yolo_full``
      and ``finetune_yolo_head`` at the JAX defaults (batch 8, ``max_side``
      608) on seeded weights and 16 synthetic 1080p frames with one or two
      bright blocks each, 3 epochs, in precision "default" and "highest":
      ms per step (min and mean after the first), images/s, peak memory,
      the op bound, the loss history (finite); then one full step at 64
      px on the card against the CPU in "highest" (loss and parts, every
      gradient, the clip's global norm, the updated parameters);
   s. ``finetune_facenet`` at 160 px, batch 32, ``bank_size`` 0 and 256,
      on 128 crops of 16 identities (ms per step, peak memory, history),
      and one step at 75 px on the card against the CPU (the BatchNorm
      statistics' gradients and updates included);
   t. the ``ViTClassifier`` B16 step at 128 px, batch 64, with ``remat``
      False and True (one step each in "highest" agreeing to float
      rounding, then ms per step and peak memory in "default"), and one
      small step (img 32, dim 64, depth 2) on the card against the CPU;
   u. data parallelism on a mesh of two shards on cuda:0
      (``make_mesh(devices=[cuda:0, cuda:0])``, ``sharded_vs_single``):
      ``MtcnnDetector(bf16=True)`` (K1-K3) and ``FrcnnDetector(bf16=True)``
      (K4) on the 4a batch, ``FaceNetEncoder(device_resize=True)`` (K5) on
      128 crops, and ``dedup_cosine``, ``kmeans_fit`` (k = 3) and
      ``silhouette_score`` on 4e's 4,096 x 512 embeddings, each held to the
      same call with ``mesh=None`` (ms per call of both, the launches of one
      call per shard); ``mesh="auto"`` keeps one device, so 4a-4t ran on
      one device;
   v. with two cards or more: the same on a cuda:0 + cuda:1 mesh, and every
      kernel (and ``MtcnnDetector``) on cuda:1 called while the thread's
      current device is cuda:0; with one card it prints why it was skipped;
   w. a multi-host job: ``video_to_faces(mode="full", style="live",
      det_model="mtcnn")`` (MTCNN bf16, FaceNet ``device_resize``) over three
      1080p videos by two host processes on cuda:0 (this script run as
      ``chip_smoke.py --mh-host SPEC``) through a shared gather directory,
      their merged faces by label held to one process over the same videos
      in the hosts' gather order; K1-K3 and K5 launched on each host; the
      grouping ops (embedding dedup, K-means, silhouette) bit-equal in both
      hosts and this process; per host the wall, the ms of each all-gather
      and of the transport alone;
   x. the same with a gloo process group and the anime defaults (R-CNN
      bf16 + ViT ``device_resize``: K4 and K5 on each host) in
      ``mode="full"``, then ``mode="grouping"`` by the same hosts over one
      shared folder of the first run's faces.

The YOLO path (4l-4n, 4q) runs no hand-written kernel: its convolutions are
cuDNN's and its resize the matrix products of ``ops/resize.py``; its
launch counts are printed all the same. Training (4r-4t) reaches no kernel
either: the JAX package's training reaches no ``pl.pallas_call``.

Its last two lines are a JSON object listing every kernel with its launches,
error and times, and ``{"ok": true, "device": {...}}``. It imports nothing of
JAX or of the JAX package, and it fails without a CUDA device or without the
port's package beside it.
"""

import contextlib
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,   # dense bf16 tensor-core rate
            "tf32": 495e12,       # dense TF32 tensor-core rate (precision "default")
            "float32": 67e12}     # float32 on the CUDA cores (also int32 adds)
# pnet_level against its plain version: float32, accumulation order only;
# bfloat16, a one-ulp difference in one bf16-rounded map compounds through
# the four maps (the JAX package's bounds between two blockings of its own
# kernel, tests/test_models_mtcnn.py:699-706). prob lies in [0, 1]; reg is
# held to the same rtol and to atol times max|reg| of the level, since a
# flipped ulp upstream moves reg by a share of its terms, not of its value.
TOLS = {"float32": dict(rtol=1e-4, atol=1e-6),
        "bfloat16": dict(rtol=0.05, atol=5e-3)}
B, H, W, MINSIZE = 2, 1080, 1920, 5

failures = []


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(name):
    log("== " + name)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:  # every phase runs; the exit code reports failures
        import traceback

        traceback.print_exc()
        failures.append("%s: %s: %s" % (name, type(e).__name__, e))
        log("FAILED: %s" % name)
    log("   (%.1f s)" % (time.perf_counter() - t0))


def cuda_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def jax_shapes():
    """{"net/a/b/kernel": shape} of the JAX package's MTCNN parameter tree
    (the layout ``MtcnnDetector(params=...)`` takes), read off the port's
    modules: OIHW -> HWIO, [out, in] -> [in, out]."""
    from videotofaces_tpu_torch.models.mtcnn import MTCNN

    model, out = MTCNN(), {}
    for net in ("pnet", "rnet", "onet"):
        for key, val in getattr(model, net).state_dict().items():
            parts, shape = [net] + key.split("."), tuple(val.shape)
            if parts[-1] == "weight":
                parts[-1] = "kernel"
                shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
            out["/".join(parts)] = shape
    return out


def seeded_params(seed, cls_shift, reg_scale=1e-4):
    """MTCNN parameter tree (the JAX package's layout), numpy-seeded: weights
    N(0, 0.25), PReLU slopes |N| * 0.5 + 0.1, cls biases N(-0.4, 0.5) with
    ``cls_shift`` on the face logit (so that stages 2-3 see candidates),
    reg/landmark heads scaled by ``reg_scale`` (so that the cascade's boxes
    stay face-like; the kernel checks use 1, so that ``reg`` is O(1))."""
    from videotofaces_tpu_torch.utils.weights import unflatten

    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in sorted(jax_shapes().items()):
        x = rng.normal(0.0, 0.25, shape).astype(np.float32)
        if k.endswith("alpha"):
            x = np.abs(x) * 0.5 + 0.1
        if "cls" in k and k.endswith("bias"):
            x = rng.normal(-0.4, 0.5, shape).astype(np.float32)
            x[1] += cls_shift
        if "reg" in k or "lmk" in k:
            x = x * reg_scale
        out[k] = x
    return unflatten(out)


def seeded_frames(seed, b=B, h=H, w=W):
    """Smooth random uint8 BGR frames: a low-resolution noise field upsampled
    with cv2, plus fine noise."""
    import cv2

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        low = rng.integers(0, 256, (h // 24, w // 24, 3)).astype(np.uint8)
        f = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.int16)
        f += rng.integers(-12, 13, f.shape, dtype=np.int16)
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(out)


def pnet_errors(got, want):
    """max |kernel - plain| of reg and of prob, and max|reg| of the plain."""
    (reg, prob), (preg, pprob) = got, want
    return {"reg": (reg.float() - preg.float()).abs().max().item(),
            "prob": (prob - pprob).abs().max().item(),
            "reg_max": preg.float().abs().max().item()}


def check_pnet(got, want, dtype, err):
    import torch

    tol = TOLS[dtype]
    torch.testing.assert_close(got[1], want[1], **tol)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, err["reg_max"]))


def pnet_work(level_hw, b=B, h=H, w=W, dtype="bfloat16"):
    """(bytes, operations) the level's pool + PNet needs: frames read once,
    reg / prob written once; pool adds plus 2 ops per multiply-add."""
    from videotofaces_tpu_torch.ops.pnet_kernel import NPLAIN
    from videotofaces_tpu_torch.ops.resize import pool_bounds_1d

    sh, sw = level_hw
    ch, cw = sh - 2, sw - 2
    qh, qw = (ch + 1) // 2, (cw + 1) // 2
    ph, pw = qh - 4, qw - 4
    ys, ye = pool_bounds_1d(h, sh)
    xs, xe = pool_bounds_1d(w, sw)
    pool = int((ye - ys).sum()) * int((xe - xs).sum()) * 3
    macs = ch * cw * 10 * 27 + (qh - 2) * (qw - 2) * 16 * 90 + ph * pw * (32 * 144 + 6 * 32)
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = b * h * w * 3 + NPLAIN * 4 + b * ph * pw * (4 * esize + 4)
    return nbytes, b * (pool + 2 * macs)


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def crop_slots(rng, n, b=B, h=H, w=W):
    """A seeded slot table: a mix of small (8-64 px), ~300 px and > 512 px
    windows, with about a quarter of the slots dead (ok = 0)."""
    kind = rng.choice(3, n, p=[0.7, 0.2, 0.1])
    lo = np.array([8, 260, 520])[kind]
    hi = np.array([64, 340, 1000])[kind]
    wh = np.minimum(rng.integers(lo, hi + 1), h)
    ww = np.minimum((wh * rng.uniform(0.8, 1.25, n)).astype(np.int64), w)
    ww = np.maximum(ww, 1)
    y0 = rng.integers(0, h - wh + 1)
    x0 = rng.integers(0, w - ww + 1)
    ok = (rng.random(n) >= 0.25).astype(np.int64)
    return np.stack([rng.integers(0, b, n), y0, x0, wh, ww, ok], axis=1).astype(np.int32)


def crops_work(slots, out_size, b=B, h=H, w=W):
    """(bytes, operations): the union of the live windows' frame bytes read
    once, the crops written once, the slot table read once; one add per
    window byte plus a division and normalization per output."""
    live = slots[:, 5] != 0
    cover = np.zeros((b, h, w), bool)
    for img, y0, x0, wh, ww, _ in slots[live]:
        cover[img, y0:y0 + wh, x0:x0 + ww] = True
    adds = int((slots[live, 3].astype(np.int64) * slots[live, 4]).sum()) * 3
    nbytes = int(cover.sum()) * 3 + slots.shape[0] * (out_size * out_size * 3 * 4 + 24)
    return nbytes, adds + slots.shape[0] * out_size * out_size * 3 * 3


def ptxas_summary(log_text):
    """[(kernel, "N registers, M bytes smem", "spills ...")] from one
    ``nvcc -Xptxas -v`` log."""
    out, fn, props = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.strip()
        elif "Function properties for" in line:
            props = ""
        elif "spill" in line:
            props = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and fn is not None:
            out.append((fn, line.split("Used", 1)[1].strip(), props))
            fn = None
    return out


def sass_instruction_counts(so_path):
    """{kernel: {opcode: count}} of the tensor-core instructions (HMMA,
    HGMMA) in ``cuobjdump -sass`` of a built library, or None where the
    toolkit has no cuobjdump."""
    from videotofaces_tpu_torch.ops import _cuda

    tool = osp.join(osp.dirname(_cuda._nvcc()), "cuobjdump")
    if not osp.isfile(tool):
        return None
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn, opcodes = {}, None, ("HMMA", "HGMMA")
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {op: 0 for op in opcodes}
        elif fn is not None:
            for op in opcodes:
                if " %s." % op in line or " %s " % op in line:
                    counts[fn][op] += 1
    return counts


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return "nvidia-smi unavailable: %s" % e


@contextlib.contextmanager
def plain_engines():
    """Route the cascade's two kernel calls to their plain versions for
    tensors on the card (the comparison path of phase 4b)."""
    from videotofaces_tpu_torch.models import mtcnn as M
    from videotofaces_tpu_torch.ops import crops_kernel as CK
    from videotofaces_tpu_torch.ops import pnet_kernel as PK

    saved = (M.pnet_level, M.pool_crops)
    M.pnet_level, M.pool_crops = PK.pnet_level_plain, CK.pool_crops_plain
    try:
        yield
    finally:
        M.pnet_level, M.pool_crops = saved


def encoder_crops(seed, n, px=180):
    """The JAX package's encoder benchmark crop mix (bench.py:324): uint8
    noise, heights px-39..px, width px."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (px - (i % 40), px, 3)).astype(np.uint8) for i in range(n)]


def facenet_params(seed, calibrate_on=None):
    """InceptionResnetV1 parameter tree in the JAX package's layout (what
    ``FaceNetEncoder(params=...)`` takes), numpy-seeded: weights N(0, 0.05),
    BatchNorm scale 1 + N(0, 0.05), var |N| + 0.5. With ``calibrate_on``
    (a device), ``head_bn``'s mean and var are set to the head features'
    statistics over 64 smooth seeded images, so that the random network
    embeds different crops apart (otherwise all lie within ~0.005 cosine
    distance and the embedding dedup keeps one face)."""
    import cv2
    import torch

    from videotofaces_tpu_torch.models.facenet import InceptionResnetV1, preprocess_uint8
    from videotofaces_tpu_torch.utils.weights import unflatten

    bn_names = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}
    rng = np.random.default_rng(seed)
    flat = {}
    for key, val in InceptionResnetV1().state_dict().items():
        parts, shape = key.split("."), tuple(val.shape)
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[-2] in ("bn", "head_bn"):
            parts[-1] = bn_names[parts[-1]]
        elif parts[-1] == "weight":       # OIHW -> HWIO, [out, in] -> [in, out]
            parts[-1] = "kernel"
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
        x = rng.normal(0.0, 0.05, shape).astype(np.float32)
        if parts[-1] == "var":
            x = np.abs(x) + 0.5
        elif parts[-1] == "scale":
            x = 1.0 + x
        flat["/".join(parts)] = x
    tree = unflatten(flat)
    if calibrate_on is not None:
        model = InceptionResnetV1.from_jax(tree).to(calibrate_on).eval()
        crng = np.random.default_rng(seed + 1)
        imgs = np.stack([cv2.resize(crng.integers(0, 256, (8, 8, 3)).astype(np.uint8),
                                    (160, 160), interpolation=cv2.INTER_CUBIC)
                         for _ in range(64)])
        feats = []
        hook = model.head.register_forward_hook(lambda m, i, o: feats.append(o))
        x = preprocess_uint8(torch.from_numpy(imgs)).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            model(x.to(calibrate_on))
        hook.remove()
        f = feats[0].double().cpu().numpy()
        tree["head_bn"]["mean"] = f.mean(0).astype(np.float32)
        tree["head_bn"]["var"] = (f.var(0) + 1e-6).astype(np.float32)
    return tree


def vit_params(calibrate_on, seed=0):
    """The seeded ViT-B16 of a missing checkpoint, as a parameter tree in the
    JAX package's layout, with the final LayerNorm's bias set to minus its
    mean output over 64 smooth seeded images on ``calibrate_on``: the random
    network's embeddings all point one way (within the embedding dedup's
    0.25 cosine distance of each other), and centering them spreads them."""
    import cv2
    import torch

    from videotofaces_tpu_torch.models import vit as V
    from videotofaces_tpu_torch.utils.weights import vit_to_jax

    model = V.ViT.seeded(0, **V.B16).to(calibrate_on).eval()
    crng = np.random.default_rng(seed + 1)
    imgs = np.stack([cv2.resize(crng.integers(0, 256, (8, 8, 3)).astype(np.uint8),
                                (128, 128), interpolation=cv2.INTER_CUBIC)
                     for _ in range(64)])
    x = V.preprocess_uint8(torch.from_numpy(imgs)).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        emb = model(x.to(calibrate_on)).double().mean(0).cpu().numpy()
    tree = vit_to_jax(model.state_dict())
    tree["norm"]["bias"] = (tree["norm"]["bias"] - emb).astype(np.float32)
    return tree


def resize_work(sizes_np, out):
    """(bytes, operations) of K5: each crop's pixels read once, the sizes,
    the float32 NCHW output written once; per output pixel 16 operations
    for the two axes' taps and 9 per channel (4 products, 3 sums, the
    normalization)."""
    n = sizes_np.shape[0]
    nbytes = int((sizes_np[:, 0].astype(np.int64) * sizes_np[:, 1]).sum()) * 3 \
        + n * 8 + n * 3 * out * out * 4
    return nbytes, n * out * out * (16 + 3 * 9)


def library_resize(packed, sizes_np, out, scale, mean):
    """The nearest library computation of K5: one ``F.interpolate``
    (bilinear, half-pixel) per image, then BGR -> RGB and normalize."""
    import torch
    import torch.nn.functional as F

    res = torch.empty((packed.shape[0], 3, out, out), dtype=torch.float32,
                      device=packed.device)
    for k, (h, w) in enumerate(sizes_np.tolist()):
        img = packed[k, :h, :w].permute(2, 0, 1)[None].float()
        r = F.interpolate(img, size=(out, out), mode="bilinear", align_corners=False)
        res[k] = (r[0].flip(0) - mean) * scale
    return res


def unit_blobs(seed, n, d=512, k=8, spread=0.6):
    """n seeded unit vectors in k well-separated clusters (embedding-like)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(0, spread / np.sqrt(d) * 4, (n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def jax_layout_shapes(module, rename=()):
    """{"a/b/kernel": shape} of a port module's parameters in the JAX
    package's layout (what the wrappers' ``params=`` take): OIHW -> HWIO,
    [out, in] -> [in, out], BatchNorm {weight, bias, running_mean,
    running_var} -> {scale, bias, mean, var}, LayerNorm weight -> scale;
    ``rename`` maps first-level module names (port -> JAX)."""
    bn = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    out = {}
    for key, val in module.state_dict().items():
        parts, shape = key.split("."), tuple(val.shape)
        if parts[-1] == "num_batches_tracked":
            continue
        if len(parts) > 1 and parts[-2] == "bn":
            parts[-1] = bn[parts[-1]]
        elif parts[-1] == "weight" and len(shape) in (2, 4):
            parts[-1] = "kernel"
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
        elif parts[-1] == "weight":
            parts[-1] = "scale"
        parts[0] = dict(rename).get(parts[0], parts[0])
        out["/".join(parts)] = shape
    return out


def frcnn_params(seed, cls_shift=1.0):
    """Faster R-CNN {"body", "head"} tree in the JAX package's layout, the
    recipe of the port's parity tests (tests/test_torch_rcnn.py): kernels
    N(0, 1/fan_in) (regression heads x 0.1), BatchNorm scale 1 + N(0, 0.1)
    (x 0.2 on each bottleneck's last unit), var 0.8 + |N| * 0.2, biases and
    means N(0, 0.1), and the RoI head's face logit shifted by
    ``cls_shift``."""
    import torch

    from videotofaces_tpu_torch.models.rcnn import AnimeFRCNN
    from videotofaces_tpu_torch.utils.weights import unflatten

    with torch.device("meta"):
        model = AnimeFRCNN()
    rng = np.random.default_rng(seed)
    flat = {}
    for part in ("body", "head"):
        shapes = jax_layout_shapes(getattr(model, part), (("backbone", "ResNet_0"),))
        for key, shape in sorted(shapes.items()):
            keys = key.split("/")
            name = keys[-1]
            x = rng.normal(0.0, 1.0, shape)
            if name == "kernel":
                x *= np.sqrt(1.0 / np.prod(shape[:-1])) * (0.1 if keys[-2] == "reg" else 1.0)
            elif name == "var":
                x = np.abs(x) * 0.2 + 0.8
            elif name == "scale":
                x = (0.2 if "u3" in keys else 1.0) * (1.0 + 0.1 * x)
            else:
                x *= 0.1
            if part == "head" and keys[-2] == "cls" and name == "bias":
                x[0] += cls_shift
            flat[part + "/" + key] = x.astype(np.float32)
    return unflatten(flat)


def yolo_params(seed, obj_shift=0.0, cls_shift=0.0, reg_scale=0.1):
    """YOLOv3 {"backbone", "neck", "head"} tree in the JAX package's layout,
    the recipe of the port's parity tests (tests/test_torch_yolo.py) drawn
    in the port's key order: kernels N(0, 1.6/fan_in) (the heads'
    regression columns x ``reg_scale``), BatchNorm scale 1 + N(0, 0.1) (x
    0.2 on each residual block's second unit), var 0.8 + |N| * 0.2, biases
    and means N(0, 0.1); the heads' objectness and class biases shifted by
    ``obj_shift`` and ``cls_shift``."""
    import torch

    from videotofaces_tpu_torch.models.yolo import YOLOv3
    from videotofaces_tpu_torch.utils.weights import unflatten

    with torch.device("meta"):
        model = YOLOv3()
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in sorted(jax_layout_shapes(model).items()):
        keys = key.split("/")
        name = keys[-1]
        x = rng.normal(0.0, 1.0, shape)
        if name == "kernel":
            x *= np.sqrt(1.6 / np.prod(shape[:-1]))
            if keys[-2].startswith("pred"):
                x[..., (np.arange(shape[-1]) % 6) < 4] *= reg_scale
        elif name == "var":
            x = np.abs(x) * 0.2 + 0.8
        elif name == "scale":
            x = (0.2 if keys[-3] == "conv2" and "_res" in keys[-4] else 1.0) * (1.0 + 0.1 * x)
        else:
            x *= 0.1
            if keys[-2].startswith("pred") and name == "bias":
                x[4::6] += obj_shift
                x[5::6] += cls_shift
        flat[key] = x.astype(np.float32)
    return unflatten(flat)


def yolo_candidates(det, batch):
    """Per image of ``batch``: the candidates that pass the score thresholds
    and the valid slots that enter NMS (at most ``pre_topk`` = 1,000); D,
    the candidates on the canvas; and the batch's convolution operations
    (2 x multiply-adds) — the detector's preprocess, network and selection
    run again outside the timed calls."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.models import yolo as Y

    h, w = batch[0].shape[:2]
    resized, canvas, priors, _ = det._geometry(h, w)
    x = torch.from_numpy(np.stack(batch)).to(det.device)
    flops = []
    hooks = [m.register_forward_hook(lambda mod, i, o: flops.append(
        2 * o.numel() * mod.weight[0].numel()))
        for m in det.model.modules() if isinstance(m, torch.nn.Conv2d)]
    with config.model_call(), torch.inference_mode():
        maps = [m.float() for m in det.model(Y.preprocess(x, resized, canvas,
                                                          det.compute_dtype))]
        vals, _, _ = Y.select_candidates(maps, pre_topk=priors.shape[0])
    for hk in hooks:
        hk.remove()
    passing = (vals > 0).sum(1).tolist()
    return passing, [min(n, 1000) for n in passing], priors.shape[0], sum(flops)


def matched_share(a, b, iou=0.99):
    """Share of the boxes of ``a`` that a box of ``b`` overlaps at IoU >= iou."""
    import torch

    from videotofaces_tpu_torch.ops.boxes import box_iou_matrix

    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    m = box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).max(1).values
    return float((m >= iou).float().mean())


@contextlib.contextmanager
def patched_factories(**factories):
    """Route ``video_to_faces``'s model factories (``get_detector_model``,
    ``get_encoder_model`` of the port's api module) to ``factories``."""
    from videotofaces_tpu_torch import api

    saved = {name: getattr(api, name) for name in factories}
    for name, fn in factories.items():
        setattr(api, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(api, name, fn)


def roi_synthetic_boxes():
    """Boxes on a 1080p frame's 750 x 1333 canvas that every roi table of 3d
    carries: sqrt(wh) from three float32 ulps below to one above each level
    edge (112, 224, 448; boxes at the origin, so that w and h are exact),
    one box per level, a 1:20 box (k = 11 > 8 samples per bin on P3), a 1 px
    box and a box running off the canvas."""
    out = []
    for v in (112.0, 224.0, 448.0):
        s = np.float32(v)
        for _ in range(3):
            s = np.nextafter(s, np.float32(0))
        for _ in range(5):
            out.append([0.0, 0.0, float(s), float(s)])
            s = np.nextafter(s, np.float32(1e9))
    out += [[40.0, 60.0, 80.0, 100.0], [300.0, 200.0, 460.0, 360.0],
            [500.0, 100.0, 800.0, 400.0], [600.0, 50.0, 1300.0, 740.0],
            [10.0, 300.0, 610.0, 330.0], [700.0, 500.0, 701.0, 501.0],
            [1200.0, 650.0, 1500.0, 900.0]]
    return np.asarray(out, np.float32)


def roi_axis_samples(c1, c2, size):
    """[n] samples of n rois along one axis that lie inside [-1, size],
    over the 7 bins: k from ``RA.samples_per_bin`` and the coordinates in
    float32 as the function computes them (``RA._axis_weights``)."""
    import torch

    from videotofaces_tpu_torch.ops import roi_align as RA

    k = RA.samples_per_bin(c1, c2)
    bin_size = (c2 - c1) * RA.inv_out()
    step = bin_size / torch.clamp(k.to(torch.float32), min=1.0)
    i = torch.arange(RA.OUT_SIZE, dtype=torch.float64)
    row = (c1.double()[:, None] + i * bin_size.double()[:, None]).float()
    j = torch.arange(RA.K_MAX)
    y = row[:, :, None] + (j + 0.5).float() * step[:, None, None]
    ok = (j < k[:, None, None]) & (y >= -1.0) & (y <= size)
    return ok.sum((1, 2))


def roi_work(boxes, valid, fmap_hw, c, esize):
    """(bytes, operations) of K4 on this run's rois: the level pixels that
    valid rois touch (each roi's feature-coordinate rectangle, clipped, plus
    the bilinear halo; their union per image and level) read once, the
    pooled float32 output, boxes, levels and flags; per sample inside the
    level and per channel, 4 taps x a multiply-add, plus one scale per
    output."""
    import torch

    from videotofaces_tpu_torch.ops import roi_align as RA

    lv = RA.assign_fpn_levels(boxes).cpu()
    bx, v = boxes.float().cpu(), valid.cpu()
    b, r = v.shape
    touched = samples = 0
    for level, (h, w) in enumerate(fmap_hw):
        cover = np.zeros((b, h, w), bool)
        for img in range(b):
            idx = torch.nonzero(v[img] & (lv[img] == level)).flatten()
            if idx.numel() == 0:
                continue
            x1, y1, x2, y2 = RA.roi_coords(bx[img, idx], RA.STRIDES[level])
            samples += int((roi_axis_samples(y1, y2, h) * roi_axis_samples(x1, x2, w)).sum())
            for fy1, fx1, fy2, fx2 in zip(y1.tolist(), x1.tolist(), y2.tolist(), x2.tolist()):
                ys = slice(max(int(np.floor(fy1)), 0), max(min(int(np.ceil(fy2)) + 2, h), 0))
                xs = slice(max(int(np.floor(fx1)), 0), max(min(int(np.ceil(fx2)) + 2, w), 0))
                cover[img, ys, xs] = True
        touched += int(cover.sum())
    nbytes = touched * c * esize + b * r * (49 * c * 4 + 16 + 4 + 1)
    return nbytes, samples * c * 8 + b * r * 49 * c


@contextlib.contextmanager
def plain_roi_align():
    """Route the detector's RoIAlign to its plain version for tensors on the
    card (the comparison path of phase 4i)."""
    import torch

    from videotofaces_tpu_torch.models import rcnn as R
    from videotofaces_tpu_torch.ops import roi_align as RA

    def plain(fmaps, boxes, valid, strides):
        zeros = torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)
        return RA.roi_align_fpn_plain(fmaps, boxes, valid, strides), zeros, valid.clone(), zeros

    saved = R.roi_align_fpn
    R.roi_align_fpn = plain
    try:
        yield
    finally:
        R.roi_align_fpn = saved


def _kernel_fns():
    from videotofaces_tpu_torch.ops import crops_kernel as CK
    from videotofaces_tpu_torch.ops import pnet_kernel as PK
    from videotofaces_tpu_torch.ops import resize_kernel as RK
    from videotofaces_tpu_torch.ops import roi_align_kernel as RAK

    return {"pnet_level": PK.pnet_level, "pool_crops": CK.pool_crops,
            "resize_normalize": RK.resize_normalize, "roi_align": RAK.roi_align_cuda}


def reset_launches():
    for fn in _kernel_fns().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def write_video(path, frames, fps):
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(f)
    vw.release()


def profile_batch(det, batch, top=15):
    """Where the time goes: one more batch under torch.profiler — device
    kernel time by name (the ``top`` largest), and the device's busy and
    idle share of the batch's wall time. A measurement aid: a profiler that
    yields nothing is reported, not failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            det(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        self_dev = lambda e: (getattr(e, "self_device_time_total", None)
                              or getattr(e, "self_cuda_time_total", 0))
        evs = [e for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", "")) and self_dev(e) > 0]
    except Exception as e:  # noqa: BLE001 - see docstring
        log("   profiler unavailable: %s: %s" % (type(e).__name__, e))
        return
    dev_ms = sum(self_dev(e) for e in evs) / 1e3
    log("   profiled batch: wall %.2f ms, device kernels %.2f ms, busy %.1f%%, "
        "idle %.1f%%" % (wall, dev_ms, 100 * dev_ms / wall, 100 - 100 * dev_ms / wall))
    for e in sorted(evs, key=lambda e: -self_dev(e))[:top]:
        log("     %8.3f ms  x%-5d %s" % (self_dev(e) / 1e3, e.count, e.key[:100]))


def k5_profiler_ms(packed, hw, out, scale, mean, iters=20):
    """Median and all device times (ms) of ``iters`` K5 launches under
    torch.profiler: the kernel's own time, without the launch gaps that an
    event-timed loop of ~30 us launches includes. None where the profiler
    shows no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from videotofaces_tpu_torch.ops import resize_kernel as RK

    RK.resize_normalize(packed, hw, out, scale, mean)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            RK.resize_normalize(packed, hw, out, scale, mean)
        torch.cuda.synchronize()
    times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if "resize_normalize_kernel" in e.name
                   and "CUDA" in str(getattr(e, "device_type", "")))
    return (float(np.median(times)), times) if times else (None, [])


def serve_in_thread(srv):
    """Run a socket or HTTP server's loop on a daemon thread."""
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


def ms_line(times):
    return "min %.2f, mean %.2f (all %s)" % (np.min(times), np.mean(times),
                                             ", ".join("%.2f" % t for t in times))


def assert_same_pairs(got, want):
    """Per-frame (boxes, scores) replies equal exactly."""
    assert len(got) == len(want)
    for (gb, gs), (wb, ws) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gb, np.float32).reshape(-1, 4), wb)
        np.testing.assert_array_equal(np.asarray(gs, np.float32).ravel(), ws)


def assert_same_extract(got, want):
    """Per-frame extract replies equal exactly: int boxes, float32 scores and
    embeddings (JSON carries float32 values exactly as float64)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["boxes"], np.int64).reshape(-1, 4),
                                      w["boxes"])
        np.testing.assert_array_equal(np.asarray(g["scores"], np.float32).ravel(),
                                      w["scores"])
        emb = np.asarray(g["embeddings"], np.float32)
        np.testing.assert_array_equal(emb.reshape(w["embeddings"].shape), w["embeddings"])


def wire_echo_ms(frames, iters=5):
    """ms of framed round trips of ``frames`` over loopback TCP with the
    serve module's framing (the client's ``np.stack``, ``_send_frame``, the
    server's ``_recv_frame``, a small reply) and no model: the transport's
    share of a served request. The first trip is dropped."""
    import socket
    import threading

    from videotofaces_tpu_torch import serve as S

    listener = socket.create_server(("127.0.0.1", 0))

    def echo():
        conn, _ = listener.accept()
        with conn:
            while S._recv_frame(conn)[0] is not None:
                S._send_frame(conn, {"ok": True})

    thread = threading.Thread(target=echo, daemon=True)
    thread.start()
    times = []
    conn = socket.create_connection(listener.getsockname())
    try:
        for _ in range(iters + 1):
            t0 = time.perf_counter()
            S._send_frame(conn, {"op": "echo"}, [np.stack(frames).astype(np.uint8)])
            S._recv_frame(conn)
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        conn.close()
        thread.join(30)
        listener.close()
    assert not thread.is_alive()
    return times[1:]


def daemon_cold_start(root, args, frames, timeout=600):
    """``python -m videotofaces_tpu_torch.serve ARGS --tcp 127.0.0.1:0`` in a
    fresh process: seconds from spawn to listening (imports, CUDA context,
    model init, kernel build check, ``--warmup-res``), then the ms of its
    first ``extract`` of ``frames`` and of a second; the daemon is shut
    down (killed on any failure)."""
    import ast
    import threading

    from videotofaces_tpu_torch.serve import ServeClient

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "videotofaces_tpu_torch.serve", *args,
                             "--tcp", "127.0.0.1:0"], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("v2f serving on "):
                break
        else:
            raise RuntimeError("the daemon never listened:\n" + "".join(lines[-20:]))
        listening = time.perf_counter() - t0
        client = ServeClient(ast.literal_eval(line[len("v2f serving on "):]))
        try:
            first = timed(client.extract, frames)[1]
            second = timed(client.extract, frames)[1]
            client.shutdown()
        finally:
            client.close()
        assert proc.wait(timeout=60) == 0
        return listening, first, second
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def served_anime_tcp(root, batch, dev, kernels):
    """4o: the anime defaults (Faster R-CNN with the seeded recipe, ViT-B16
    with ``device_resize``) served on 127.0.0.1:0 by the binary daemon in a
    thread; every reply must equal the direct call. Then the CLI daemon's
    cold start in a fresh process, and K5's profiler kernel times."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.ops import resize_kernel as RK
    from videotofaces_tpu_torch.serve import FaceService, ServeClient, make_server

    config.set_precision("default")
    svc = FaceService(style="anime", det_kw={"params": frcnn_params(0)},
                      enc_kw={"device_resize": True})
    assert svc.device.type == "cuda"
    _, warm_ms = timed(svc.warmup, [(H, W)], [B], [16])
    log("   warmup (1080p at batch %d, encoder batch 16): %.1f ms, in a process whose "
        "earlier phases made the CUDA context and built the kernels" % (B, warm_ms))
    crops = encoder_crops(4, 16)
    srv = make_server(svc, ("127.0.0.1", 0))
    thread = serve_in_thread(srv)
    client = ServeClient(srv.server_address[:2])
    reset_launches()
    try:
        assert client.ping() is True
        det_got, det_ms = zip(*[timed(client.detect, batch) for _ in range(5)])
        ex_got, ex_ms = zip(*[timed(client.extract, batch) for _ in range(5)])
        emb_got, emb_ms = zip(*[timed(client.embed, crops) for _ in range(5)])
        stats = client.stats()
        client.shutdown()
    finally:
        client.close()
    thread.join(30)
    srv.server_close()
    assert not thread.is_alive()
    torch.cuda.synchronize()
    launches = read_launches()
    det_want, det_direct = zip(*[timed(svc.detect, batch) for _ in range(5)])
    ex_want, ex_direct = zip(*[timed(svc.extract, batch) for _ in range(5)])
    emb_want, emb_direct = zip(*[timed(svc.embed, crops) for _ in range(5)])
    faces = [len(r["boxes"]) for r in ex_want[0]]
    log("   stats %s; faces per frame %s; launches over the served requests %s"
        % (stats, faces, launches))
    for op, served, direct in (("detect (2 x 1080p)", det_ms, det_direct),
                               ("extract (2 x 1080p)", ex_ms, ex_direct),
                               ("embed (16 crops)", emb_ms, emb_direct)):
        log("   %-20s served ms: first after warmup %.2f, steady %s; direct call ms %s"
            % (op, served[0], ms_line(served[1:]), ms_line(direct)))
    log("   the wire alone (2 x 1080p frames framed over loopback TCP, no model) ms %s"
        % ms_line(wire_echo_ms(batch)))
    for got in det_got:
        assert_same_pairs(got, det_want[0])
    for got in ex_got:
        assert_same_extract(got, ex_want[0])
    for got in emb_got:
        np.testing.assert_array_equal(got, emb_want[0])
    assert sum(faces) > 0, "the served anime path found no faces"
    assert launches["roi_align"] == 10 and launches["resize_normalize"] > 0, launches
    del svc
    listening, first, second = daemon_cold_start(
        root, ["--style", "anime", "--warmup-res", str(H), str(W)], batch)
    log("   CLI daemon in a fresh process (anime defaults, checkpoint-less seeded "
        "weights, precision 'highest', --warmup-res %d %d): listening after %.2f s; "
        "first extract %.2f ms, second %.2f ms" % (H, W, listening, first, second))
    packed_np, sizes_np = RK.pack_images(encoder_crops(3, 128), 256)
    packed = torch.from_numpy(packed_np).to(dev)
    hw = torch.from_numpy(sizes_np).to(dev)
    k5 = {}
    for out, scale in ((160, 1 / 128.0), (128, 1 / 127.5)):
        med, all_ms = k5_profiler_ms(packed, hw, out, scale, 127.5)
        bnd, _ = bound_ms(*resize_work(sizes_np, out), "float32")
        k5["out%d" % out] = dict(median_ms=med, bound_ms=bnd,
                                 min_ms=all_ms[0] if all_ms else None,
                                 max_ms=all_ms[-1] if all_ms else None)
        log("   K5 profiler kernel time at out %d (N=128, 20 launches): median, min, max "
            "%s ms; bound %.4f ms" % (out, ", ".join(
                "%.4f" % v for v in (med, all_ms[0], all_ms[-1])) if all_ms else "none", bnd))
    if "resize_normalize" in kernels:
        kernels["resize_normalize"]["profiler"] = k5


def served_mtcnn_http(batch, dev):
    """4p: the MTCNN cascade (bf16) + FaceNet (``device_resize``) behind the
    HTTP gateway with PNG-encoded frames; /detect and /extract must equal
    the direct call."""
    import torch

    from videotofaces_tpu_torch import config
    import base64
    import urllib.request

    import cv2

    from videotofaces_tpu_torch.serve import FaceService, make_http_server
    from videotofaces_tpu_torch.specs import BoxCriteria

    config.set_precision("default")
    svc = FaceService(style="live", det_model="mtcnn",
                      criteria=BoxCriteria(min_size=20, min_border=0),
                      det_kw={"bf16": True, "params": seeded_params(0, 2.0)},
                      enc_kw={"device_resize": True, "params": facenet_params(5, dev)})
    svc.warmup([(H, W)], [B], [16])
    b64, enc_ms = timed(lambda: [base64.b64encode(cv2.imencode(".png", f)[1]).decode()
                                 for f in batch])
    decoded, dec_ms = timed(lambda: [cv2.imdecode(np.frombuffer(base64.b64decode(t),
                                                                np.uint8),
                                                  cv2.IMREAD_COLOR) for t in b64])
    for f, g in zip(batch, decoded):
        np.testing.assert_array_equal(f, g)
    srv = make_http_server(svc, ("127.0.0.1", 0))
    thread = serve_in_thread(srv)
    base = "http://%s:%d" % srv.server_address[:2]

    def post(path, obj):
        req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    reset_launches()
    try:
        det_got, det_ms = zip(*[timed(post, "/detect", {"frames": b64}) for _ in range(5)])
        ex_got, ex_ms = zip(*[timed(post, "/extract", {"frames": b64}) for _ in range(5)])
        post("/shutdown", {})
    finally:
        thread.join(30)
        srv.server_close()
    assert not thread.is_alive()
    torch.cuda.synchronize()
    launches = read_launches()
    det_want, det_direct = zip(*[timed(svc.detect, batch) for _ in range(5)])
    ex_want, ex_direct = zip(*[timed(svc.extract, batch) for _ in range(5)])
    faces = [len(r["boxes"]) for r in ex_want[0]]
    log("   faces per frame %s; launches over the served requests %s" % (faces, launches))
    log("   PNG codec per request of 2 frames (%.1f MB of PNG): encode (client) %.2f ms, "
        "decode (the server's work, timed alone) %.2f ms"
        % (sum(len(t) for t in b64) * 3 / 4 / 1e6, enc_ms, dec_ms))
    for op, served, direct in (("/detect", det_ms, det_direct),
                               ("/extract", ex_ms, ex_direct)):
        log("   %-8s HTTP ms: first after warmup %.2f, steady %s; direct service call "
            "ms %s; HTTP minus service minus PNG decode: %.2f ms"
            % (op, served[0], ms_line(served[1:]), ms_line(direct),
               np.mean(served[1:]) - np.mean(direct) - dec_ms))
    for got in det_got:
        assert_same_pairs([(r["boxes"], r["scores"]) for r in got["results"]],
                          det_want[0])
    for got in ex_got:
        assert_same_extract(got["results"], ex_want[0])
    assert sum(faces) > 0, "the served MTCNN path found no faces"
    for name in ("pnet_level", "pool_crops", "resize_normalize"):
        assert launches[name] > 0, "%s was not launched on the served path" % name
    del svc


def served_concurrent(dev):
    """4q: the live defaults (YOLOv3 + FaceNet) on a unix socket: 4 client
    threads x 3 extract requests at once beside one in-process caller
    holding precision "highest"; every reply must equal the serial direct
    call of its thread's precision (the wire carries no precision: a served
    request runs under the daemon's process default)."""
    import torch

    from videotofaces_tpu_torch import config
    import threading

    from videotofaces_tpu_torch.serve import FaceService, ServeClient, make_server

    config.set_precision("default")
    svc = FaceService(style="live", det_kw={"params": yolo_params(
        0, obj_shift=2.0, cls_shift=2.0, reg_scale=0.6)},
        enc_kw={"params": facenet_params(5, dev)})
    svc.warmup([(H, W)], [B], [16])
    inputs = [list(seeded_frames(40 + t)) for t in range(5)]
    precs = ["default"] * 4 + ["highest"]
    serial = []
    t0 = time.perf_counter()
    for frames_t, prec in zip(inputs, precs):
        with config.precision_scope(prec):
            serial.append(svc.extract(frames_t))
    serial_s = time.perf_counter() - t0
    faces = [[len(r["boxes"]) for r in res] for res in serial]
    assert all(sum(f) > 0 for f in faces), faces
    with config.precision_scope("default"):
        other = svc.extract(inputs[4])
    diff = max(np.abs(a["embeddings"] - b["embeddings"]).max()
               for a, b in zip(serial[4], other) if len(a["boxes"]) == len(b["boxes"]))
    log("   faces per frame %s; 'highest' vs 'default' on the same frames: max|emb "
        "diff| %.3g" % (faces, diff))
    assert diff > 0, "the two precisions agree: the check would show nothing"
    with tempfile.TemporaryDirectory() as tmp:
        sock = osp.join(tmp, "v2f.sock")
        srv = make_server(svc, sock)
        thread = serve_in_thread(srv)
        start = threading.Barrier(5)
        replies, errors = {t: [] for t in range(5)}, []

        def run(t):
            try:
                start.wait(60)
                if t == 4:
                    with config.precision_scope("highest"):
                        for _ in range(3):
                            replies[t].append(svc.extract(inputs[t]))
                    return
                client = ServeClient(sock)
                try:
                    for _ in range(3):
                        replies[t].append(client.extract(inputs[t]))
                finally:
                    client.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append("thread %d: %r" % (t, e))

        workers = [threading.Thread(target=run, args=(t,)) for t in range(5)]
        reset_launches()
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(300)
        wall = time.perf_counter() - t0
        launches = read_launches()
        client = ServeClient(sock)
        try:
            stats = client.stats()
            client.shutdown()
        finally:
            client.close()
        thread.join(30)
        srv.server_close()
    assert not thread.is_alive() and not any(w.is_alive() for w in workers)
    assert not errors, errors
    log("   15 concurrent extracts (12 served, 3 in-process) in %.2f s, %.1f ms per "
        "extract; the 5 threads' inputs once each, serially in-process: %.2f s, %.1f ms "
        "per extract; stats %s; launches %s"
        % (wall, wall / 15 * 1e3, serial_s, serial_s / 5 * 1e3, stats, launches))
    for t in range(5):
        assert len(replies[t]) == 3
        for got in replies[t]:
            assert_same_extract(got, serial[t])


# -- training (4r-4t) -----------------------------------------------------------
# card against CPU, one step at a small size in precision "highest": the
# tolerances of the port's CPU parity tests (tests/torch_train_ref.py)
STEP_TOLS = dict(loss_rtol=1e-5, grad_rtol=1e-4, grad_share=1e-5)


def face_frames(seed, n=16, h=H, w=W):
    """``n`` smooth seeded frames, each with one or two bright blocks (the
    faces of the JAX package's training tests, at 1080p) and their boxes."""
    rng = np.random.default_rng(seed)
    frames = seeded_frames(seed, b=n, h=h, w=w)
    gts = []
    for f in frames:
        boxes = []
        for _ in range(int(rng.integers(1, 3))):
            s = int(rng.integers(h // 12, h // 4))
            x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
            f[y:y + s, x:x + s] = (210, 180, 160)
            boxes.append([x, y, x + s, y + s])
        gts.append(np.asarray(boxes, np.float32))
    return frames, gts


def small_faces(seed, n, size=64):
    """The JAX package's training-test faces: dim noise, one bright block."""
    rng = np.random.default_rng(seed)
    frames, gts = [], []
    for _ in range(n):
        f = (rng.random((size, size, 3)) * 60).astype(np.uint8)
        x, y = int(rng.integers(4, size - 28)), int(rng.integers(4, size - 28))
        s = int(rng.integers(16, 26))
        f[y:y + s, x:x + s] = (210, 180, 160)
        frames.append(f)
        gts.append(np.asarray([[x, y, x + s, y + s]], np.float32))
    return np.stack(frames), gts


def identity_crops(seed, ids, per_id, px):
    """uint8 BGR crops, ``per_id`` per identity, labels the identities: each
    crop is half a smooth seeded image of its identity and half one of its
    own — identities a random network does not yet separate (the triplet
    loss starts above 0) — plus per-pixel noise of +-10."""
    import cv2

    rng = np.random.default_rng(seed)

    def smooth():
        return cv2.resize(rng.integers(0, 256, (6, 6, 3)).astype(np.uint8), (px, px),
                          interpolation=cv2.INTER_CUBIC).astype(np.float32)

    crops, labels = [], []
    for k in range(ids):
        base = smooth()
        for _ in range(per_id):
            crops.append(np.clip(0.5 * base + 0.5 * smooth()
                                 + rng.integers(-10, 11, base.shape), 0, 255))
            labels.append(k)
    return np.stack(crops).astype(np.uint8), np.asarray(labels, np.int32)


def forward_ops(model, x, kinds):
    """{top-level module: 2 x multiply-adds} of the convolutions and dense
    layers (``kinds``) in one forward of ``x``."""
    import torch

    ops = {}

    def count(mod, i, o, top):
        ops[top] = ops.get(top, 0) + 2 * o.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(lambda mod, i, o, top=name.split(".")[0]:
                                     count(mod, i, o, top))
             for name, m in model.named_modules() if isinstance(m, kinds)]
    with torch.no_grad():
        model(x)
    for hk in hooks:
        hk.remove()
    return ops


@contextlib.contextmanager
def step_timer(module, name, times):
    """Wrap the training step ``module.name`` (which a fine-tune loop calls by
    name) so that each call starts and ends with a device sync and appends
    its ms to ``times``."""
    import torch

    step = getattr(module, name)

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, timed_step)
    try:
        yield
    finally:
        setattr(module, name, step)


def step_line(label, times, batch, peak, bnd):
    steady = times[1:]
    return ("   %s: ms per step (after the first) min %.2f, mean %.2f; first %.2f; "
            "%.1f images/s; peak memory %.2f GiB; op bound %.3f ms (%.1f %% of the min)"
            % (label, np.min(steady), np.mean(steady), times[0],
               batch * 1e3 / np.mean(steady), peak / 2 ** 30, bnd,
               100.0 * bnd / np.min(steady)))


def check_grads(got, want, share=STEP_TOLS["grad_share"], zero=()):
    """Gradients after one step, ``got`` against ``want`` (flat {name:
    array}, the same names): per tensor within rtol 1e-4 and ``share`` x its
    max|want|; the tensors whose names end with one of ``zero`` (0 in exact
    arithmetic) both within 1e-6 x the largest gradient. Returns the worst
    error over its bound. The port's CPU parity tests use it too."""
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for k in sorted(want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if zero and k.endswith(zero):
            assert max(np.abs(w).max(), np.abs(g).max()) <= 1e-6 * top, k
            continue
        bound = STEP_TOLS["grad_rtol"] * np.abs(w) + share * np.abs(w).max()
        ratio = float((np.abs(g - w) / np.maximum(bound, 1e-30)).max())
        assert ratio <= 1.0, (k, ratio)
        worst = max(worst, ratio)
    return worst


def check_params(got, want, before, grads, lr, scale_of=lambda k: 1.0):
    """Parameters after one step, ``got`` against ``want`` (flat {name:
    array}); ``before``: the leaves before it, ``grads``: the reference
    gradients, ``scale_of(name)``: the leaf's lr scale. Within 1e-5 of
    max(|p before|, |p after|) where |g| > 1e-3 x the tensor's max and |g| >
    1e-5; within 2 x lr x scale elsewhere (AdamW's first step is about lr x
    sign(g), and rounding can flip the sign of a near-zero gradient); frozen
    leaves (scale 0) equal. Returns the worst error over its bound."""
    assert set(got) == set(want), set(got) ^ set(want)
    worst = 0.0
    for k in sorted(want):
        p, w, scale = np.asarray(got[k]), np.asarray(want[k]), scale_of(k)
        assert p.shape == w.shape, (k, p.shape, w.shape)
        if scale == 0.0:
            np.testing.assert_array_equal(p, w, err_msg=k)
            continue
        g = np.abs(grads[k])
        big = (g > 1e-3 * g.max()) & (g > 1e-5)
        err = np.abs(p - w)
        if big.any():
            bound = 1e-5 * np.maximum(np.abs(w), np.abs(before[k]))[big]
            ratio = float((err[big] / bound).max())
            assert ratio <= 1.0, (k, ratio)
            worst = max(worst, ratio)
        if (~big).any():
            assert err[~big].max() <= 2 * lr * scale, k
    return worst


def hold_step(card, cpu, before, out_card, out_cpu, lr, scale_of=lambda k: 1.0,
              grad_share=STEP_TOLS["grad_share"], zero=()):
    """One training step on the card (``card``, the module after it) against
    the same step on the CPU: the loss and aux within rtol 1e-5, the
    gradients by ``check_grads``, the parameters by ``check_params``.
    Returns the worst gradient and parameter errors over their bounds."""
    from videotofaces_tpu_torch.train.optim import leaves

    (loss_c, aux_c), (loss_p, aux_p) = out_card, out_cpu
    np.testing.assert_allclose(float(loss_c), float(loss_p), rtol=STEP_TOLS["loss_rtol"])
    for k in aux_p:
        np.testing.assert_allclose(float(aux_c[k]), float(aux_p[k]),
                                   rtol=STEP_TOLS["loss_rtol"], err_msg=k)
    grads = {k: t.grad.numpy() for k, t in leaves(cpu)}
    worst_g = check_grads({k: t.grad.cpu().numpy() for k, t in leaves(card)}, grads,
                          grad_share, zero)
    worst_p = check_params({k: t.detach().cpu().numpy() for k, t in leaves(card)},
                           {k: t.detach().numpy() for k, t in leaves(cpu)},
                           before, grads, lr, scale_of)
    return worst_g, worst_p


class FaceNetRouting:
    """FaceNet's branch points in one step: each ReLU's mask and each
    max-pool's argmax, in call order. ``record()`` runs the model as it is
    and keeps them; ``replay()`` makes another run take the same branches
    and counts, per call, where its own would differ (``flips``).

    Two float32 runs round differently, and a value within rounding of a
    ReLU's 0, or of the largest value of its max-pool window, takes the
    other branch on one of them: the gradient then moves by a whole
    position's share (1/72 of a weight gradient at Block17's 3 x 3 x batch
    8 at 75 px). With the branches pinned, the two runs compute one
    function, and float32 tolerances hold them to each other."""

    def __init__(self):
        self.decisions, self.flips = [], []

    @contextlib.contextmanager
    def _patched(self, relu, pool):
        import torch

        from videotofaces_tpu_torch.models import facenet as FN

        saved = torch.relu, FN.max_pool
        torch.relu, FN.max_pool = relu, pool
        try:
            yield
        finally:
            torch.relu, FN.max_pool = saved

    def record(self):
        import torch
        import torch.nn.functional as F

        relu = torch.relu

        def rec_relu(t):
            self.decisions.append(("relu", t.detach() > 0))
            return relu(t)

        def rec_pool(t):
            out, idx = F.max_pool2d(t, 3, 2, return_indices=True)
            self.decisions.append(("pool", idx))
            return out

        return self._patched(rec_relu, rec_pool)

    def replay(self):
        import torch.nn.functional as F

        it = iter(self.decisions)

        def take(kind, t, own):
            k, d = next(it)
            assert k == kind, (k, kind)
            d = d.to(t.device)
            self.flips.append((kind, int((own != d).sum()), d.numel()))
            return d

        def relu(t):
            return t * take("relu", t, t.detach() > 0)

        def pool(t):
            idx = take("pool", t, F.max_pool2d(t.detach(), 3, 2, return_indices=True)[1])
            return t.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        return self._patched(relu, pool)

    def flip_counts(self):
        """{kind: (calls with a flip, calls, flipped elements, elements)}."""
        out = {}
        for kind, n, size in self.flips:
            c, k, f, e = out.get(kind, (0, 0, 0, 0))
            out[kind] = (c + (n > 0), k + 1, f + n, e + size)
        return out


def card_vs_cpu_step(dev, build, make_opt, step, batch, lr, scale_of=lambda k: 1.0,
                     grad_share=STEP_TOLS["grad_share"], zero=(), routing=None):
    """Build the same model on the card and on the CPU, take one step of
    ``step(model, opt, *batch)`` on each in precision "highest", and hold
    the card to the CPU (``hold_step``). ``routing`` (a ``FaceNetRouting``):
    the card's branches are recorded and the CPU takes them. Returns (loss,
    the clip's global norm, worst ratios)."""
    import torch

    from videotofaces_tpu_torch import config

    runs = []
    with config.precision_scope("highest"):
        for i, d in enumerate((dev, torch.device("cpu"))):
            model = build().to(d)
            before = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
            opt = make_opt(model)
            pin = (contextlib.nullcontext() if routing is None
                   else routing.replay() if i else routing.record())
            with pin:
                loss, aux = step(model, opt, *(t.to(d) for t in batch))
            # aux: the detector's loss parts, or the active fraction / accuracy
            runs.append((model, opt, before,
                         (loss, aux if isinstance(aux, dict) else {"aux": aux})))
    (mc, oc, _, out_c), (mp, op, before, out_p) = runs
    if op.clip_norm is not None:
        np.testing.assert_allclose(float(oc.grad_norm), float(op.grad_norm),
                                   rtol=STEP_TOLS["grad_rtol"])
    worst = hold_step(mc, mp, before, out_c, out_p, lr, scale_of, grad_share, zero)
    return float(out_p[0]), float(op.grad_norm), worst


def train_yolo(dev):
    """4r: ``finetune_yolo_full`` and ``finetune_yolo_head`` at the JAX
    defaults (batch 8, ``max_side`` 608, lr 1e-4) on seeded weights, 16
    synthetic 1080p frames (canvas 352 x 608), 3 epochs (6 steps) each, in
    precision "default" and "highest"; then one full step at 64 px on the
    card against the CPU."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.models import yolo as Y
    from videotofaces_tpu_torch.train import detector as TD

    params = yolo_params(0)
    frames, gts = face_frames(31)
    canvas = Y.canvas_shape(*Y.resized_shape(H, W, 608))
    assert canvas == (352, 608), canvas
    ops = forward_ops(Y.YOLOv3.from_jax(params).to(dev), torch.zeros((8, 3) + canvas, device=dev),
                      torch.nn.Conv2d)
    fwd = sum(ops.values())
    # a step: the forward, then the input and the weight gradients of each
    # convolution (2 x the forward); the head-only step runs the trunk forward
    # only and needs no input gradient at the head's first convolutions
    step_ops = {"full": 3 * fwd, "head": fwd + 2 * ops["head"]}
    log("   batch 8 on %s: %.1f GFLOP forward (%.2f per image), full step %.1f GFLOP, "
        "head step %.1f GFLOP; %d faces in %d frames"
        % (canvas, fwd / 1e9, fwd / 8e9, step_ops["full"] / 1e9, step_ops["head"] / 1e9,
           sum(len(g) for g in gts), len(frames)))
    for prec, peak_name in (("default", "tf32"), ("highest", "float32")):
        for kind, fn, step_name in (("full", TD.finetune_yolo_full, "train_step_full"),
                                    ("head", TD.finetune_yolo_head, "train_step")):
            times = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with config.precision_scope(prec), step_timer(TD, step_name, times):
                t0 = time.perf_counter()
                tree, hist = fn(frames, gts, epochs=3, params=params)
                wall = time.perf_counter() - t0
            log(step_line("%s, %s" % (kind, prec), times, 8, torch.cuda.max_memory_allocated(),
                          step_ops[kind] / PEAK_OPS[peak_name] * 1e3))
            log("      loop %.2f s for %d steps; history %s" % (
                wall, len(times), ["%.5f" % v for v in hist]))
            assert len(times) == 6 and len(hist) == 3 and np.isfinite(hist).all(), hist
            assert sorted(tree) == ["backbone", "head", "neck"]
    small, small_gts = small_faces(5, 2)
    priors, strides = Y.flat_priors_and_strides((64, 64))
    data = TD._prepare_yolo_data(small, small_gts, priors, 0.5, 0.4, 64, 64, 64, 64)
    batch = [torch.from_numpy(data[0]).permute(0, 3, 1, 2).contiguous()] + [
        torch.from_numpy(a) for a in (data[1], data[2], priors, strides)]
    scales = {"backbone": 0.1, "neck": 0.3, "head": 1.0}
    loss, norm, worst = card_vs_cpu_step(
        dev, lambda: Y.YOLOv3.from_jax(params), lambda m: TD.layerwise_tx(m, 1e-3),
        TD.train_step_full, batch, 1e-3,
        lambda k: 0.0 if TD._is_bn_stat(k) else scales[k.split(".")[0]])
    log("   full step at 64 px, batch 2, 'highest': card = CPU (loss %.6f, global norm %.4f "
        "> clip 1.0; worst gradient error %.3f and parameter error %.3f of their bounds)"
        % (loss, norm, *worst))
    assert norm > 1.0


def train_facenet(dev):
    """4s: ``finetune_facenet`` at 160 px, batch 32, ``bank_size`` 0 and
    256, precision "default", 128 crops of 16 identities, 2 epochs (8
    steps); then one step at 75 px on the card against the CPU, which takes
    the card's ReLU masks and max-pool argmaxes (``FaceNetRouting``)."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.models import facenet as FN
    from videotofaces_tpu_torch.train import triplet as TT
    from videotofaces_tpu_torch.train.optim import AdamW, leaves

    tree = facenet_params(3, calibrate_on=dev)
    crops, labels = identity_crops(8, 16, 8, 160)
    ops = forward_ops(FN.InceptionResnetV1.from_jax(tree).to(dev),
                      torch.zeros((32, 3, 160, 160), device=dev),
                      (torch.nn.Conv2d, torch.nn.Linear))
    step_ops = 3 * sum(ops.values())
    for bank in (0, 256):
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        name = "train_step_xbm" if bank else "train_step"
        with config.precision_scope("default"), step_timer(TT, name, times):
            out, hist = TT.finetune_facenet(crops, labels, epochs=2, batch_size=32,
                                            params=tree, bank_size=bank)
        log(step_line("bank_size %d, default" % bank, times, 32,
                      torch.cuda.max_memory_allocated(), step_ops / PEAK_OPS["tf32"] * 1e3))
        log("      history %s" % ["%.5f" % v for v in hist])
        assert len(times) == 8 and np.isfinite(hist).all() and hist[0] > 0.0, hist
        assert set(out) == set(tree)
    # 8 crops of 8 bases under 4 labels: hinges the random network cannot
    # satisfy, so that the step has gradients to compare
    small, _ = identity_crops(9, 8, 1, 75)
    x = FN.preprocess_uint8(torch.from_numpy(np.ascontiguousarray(small[..., ::-1])))
    batch = [x.permute(0, 3, 1, 2).contiguous(), torch.arange(8) // 2]
    small_tree = calibrated_head_bn(tree, batch[0])
    routing = FaceNetRouting()
    loss, _, worst = card_vs_cpu_step(
        dev, lambda: FN.InceptionResnetV1.from_jax(small_tree),
        lambda m: AdamW(leaves(m), 1e-5), TT.train_step, batch, 1e-5, grad_share=1e-4,
        routing=routing)
    assert loss > 0.0
    log("   step at 75 px, batch 8, 'highest': card = CPU on the card's ReLU masks and "
        "max-pool argmaxes (loss %.6f; worst gradient error %.3g and parameter error %.3g "
        "of their bounds; BatchNorm statistics trained)" % (loss, *worst))
    log("      the CPU's own branches differ from the card's: %s"
        % "; ".join("%s %d of %d calls, %d of %d elements" % (k, *v)
                    for k, v in sorted(routing.flip_counts().items())))
    # the same step on the CPU on its own branches: what the flips move
    model = FN.InceptionResnetV1.from_jax(small_tree)
    with config.precision_scope("highest"):
        TT.train_step(model, AdamW(leaves(model), 1e-5), *batch)
    own = {k: t.grad for k, t in leaves(model)}
    model = FN.InceptionResnetV1.from_jax(small_tree).to(dev)
    with config.precision_scope("highest"):
        TT.train_step(model, AdamW(leaves(model), 1e-5), *(t.to(dev) for t in batch))
    share, at = max((float((t.grad.cpu() - own[k]).abs().max() / own[k].abs().max()), k)
                    for k, t in leaves(model))
    log("      on its own branches (not held: the flips above decide it): worst gradient "
        "difference %.3g of the tensor's max, at %s" % (share, at))


def calibrated_head_bn(tree, x):
    """``tree`` with ``head_bn``'s mean and var set to the head features'
    statistics over ``x`` (NCHW, on the CPU), so that the batch's
    embeddings spread and its hardest pairs are not near-ties."""
    import copy

    import torch

    from videotofaces_tpu_torch.models.facenet import InceptionResnetV1

    model = InceptionResnetV1.from_jax(tree)
    feats = []
    hook = model.head.register_forward_hook(lambda m, i, o: feats.append(o))
    with torch.no_grad():
        model(x)
    hook.remove()
    out = copy.deepcopy(tree)
    f = feats[0].double().numpy()
    out["head_bn"]["mean"] = f.mean(0).astype(np.float32)
    out["head_bn"]["var"] = (f.var(0) + 1e-6).astype(np.float32)
    return out


def train_vit(dev):
    """4t: ``ViTClassifier`` B16 (128 px, dim 768, depth 12) with 64
    classes, batch 64, with ``remat`` False and True: one step each in
    "highest" from the same seeded weights (losses and gradients equal to
    float rounding), then 6 steps each in "default" (ms per step, peak
    memory); then one small step (img 32, dim 64, depth 2) on the card
    against the CPU."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.train import trainer as TR
    from videotofaces_tpu_torch.train.optim import leaves

    classes, b = 64, 64
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((b, 3, 128, 128), generator=gen).to(dev)
    y = torch.randint(0, classes, (b,), generator=gen).to(dev)
    sd = TR.ViTClassifier.seeded(classes, seed=0).state_dict()
    n, d, depth = 65, 768, 12
    # per image: patch embedding, q/k/v/proj and the MLP (12 N d^2
    # multiply-adds per block), the two attention products (2 N^2 d), head
    fwd = 2 * b * (64 * 768 * d + depth * (12 * n * d * d + 2 * n * n * d) + d * classes)
    first = {}
    for remat in (False, True):
        model = TR.ViTClassifier(classes, remat=remat)
        model.load_state_dict(sd)
        model.to(dev)
        opt = TR.create_train_state(model)
        with config.precision_scope("highest"):
            loss, _ = TR.train_step(model, opt, x, y)
        first[remat] = (float(loss), {k: t.grad.detach().clone() for k, t in leaves(model)})
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with config.precision_scope("default"):
            for _ in range(6):
                t0 = time.perf_counter()
                loss, _ = TR.train_step(model, opt, x, y)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(loss))
        log(step_line("remat %s, default" % remat, times, b, torch.cuda.max_memory_allocated(),
                      (4 if remat else 3) * fwd / PEAK_OPS["tf32"] * 1e3))
        del model, opt
    (l0, g0), (l1, g1) = first[False], first[True]
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    worst = 0.0
    for k in g0:
        diff = float((g1[k] - g0[k]).abs().max())
        worst = max(worst, diff / (1e-5 * float(g0[k].abs().max()) + 1e-30))
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-5 * float(g0[k].abs().max()),
                                   msg=k)
    log("   remat vs plain, 'highest': loss %.6f vs %.6f; worst gradient difference %.3f of "
        "1e-5 x the tensor's max" % (l1, l0, worst))
    small = dict(img_size=32, patch_size=16, dim=64, depth=2)
    gen = torch.Generator().manual_seed(6)
    batch = [torch.randn((8, 3, 32, 32), generator=gen),
             torch.randint(0, 5, (8,), generator=gen)]
    loss, _, worst = card_vs_cpu_step(
        dev, lambda: TR.ViTClassifier.seeded(5, seed=1, **small),
        lambda m: TR.create_train_state(m, 1e-3), TR.train_step, batch, 1e-3,
        zero=("attn.k.bias",))
    log("   small classifier step (img 32, dim 64, depth 2), 'highest': card = CPU (loss "
        "%.6f; worst gradient error %.3f and parameter error %.3f of their bounds)"
        % (loss, *worst))


def sync_all():
    import torch

    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def ms_per_call(fn, iters=3):
    """Host ms per call (each ending in a sync of every card) after one
    warm-up call: min and mean."""
    fn()
    times = []
    for _ in range(iters):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), float(np.mean(times))


def launches_of(fn):
    """The kernel launches of one ``fn()`` call, every count set to 0
    before it."""
    reset_launches()
    fn()
    sync_all()
    return read_launches()


def assert_same_boxes(got, want, what):
    """Per image: equal counts, every detection of each side matched by one
    of the other at IoU >= 0.99 (bf16: cuDNN picks its algorithm per batch
    shape, so the two calls round differently)."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), "%s image %d: %d detections, single device %d" % (
            what, i, len(g), len(w))
        assert matched_share(g, w) == 1.0 and matched_share(w, g) == 1.0, (what, i)


def _joined(parts):
    """Per-block wrapper results joined in block order."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    if isinstance(parts[0], tuple):
        return tuple(_joined([p[j] for p in parts]) for j in range(len(parts[0])))
    return [a for p in parts for a in p]


def _identical(a, b):
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return len(a) == len(b) and all(_identical(x, y) for x, y in zip(a, b))


def sharded_vs_single(devices, frames, crops, x):
    """4u / 4v: each wrapper with ``mesh=make_mesh(devices=devices)``
    against the same wrapper with ``mesh=None`` on ``devices[0]``:
    ``MtcnnDetector(bf16=True)`` (K1-K3) and ``FrcnnDetector(bf16=True)``
    (K4) on ``frames``, ``FaceNetEncoder(device_resize=True)`` (K5) on
    ``crops``. Two holds: (1) the sharded call equals, bit for bit, the
    single-device calls on the shards' blocks (the same shapes, so the same
    cuDNN algorithms); (2) against one single-device call on the whole
    batch, MTCNN bf16 ("default") has equal counts and IoU >= 0.99 matches,
    FaceNet ("highest") is within atol 1e-4, and the R-CNN in float32 and
    "highest" has equal counts and IoU >= 0.99 matches; its bf16 share of
    matches is printed, not held: with 100 dense detections per image at
    the cut-off, the batch of 2's and the batch of 1's cuDNN algorithms
    round bf16 differently and swap borderline detections. Then
    ``dedup_cosine``, ``kmeans_fit`` (k = 3) and ``silhouette_score`` on
    ``x`` in "highest" (mins within 1e-6 and equal argmins; equal labels,
    centres within 1e-5; silhouette rtol 1e-5, atol 1e-6). Prints ms per
    call in "default" of both and the launches of one call of each, per
    shard."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.models.wrappers import (FaceNetEncoder, FrcnnDetector,
                                                        MtcnnDetector)
    from videotofaces_tpu_torch.ops import cluster_scores as CSC
    from videotofaces_tpu_torch.ops import distances as D
    from videotofaces_tpu_torch.ops.kmeans import kmeans_fit
    from videotofaces_tpu_torch.parallel import make_mesh, split_rows

    mesh = make_mesh(devices=devices)
    n = mesh.shape["data"]
    dev0 = mesh.devices[0]
    log("   mesh %r: %d shard(s), %d module copy(ies) per wrapper"
        % (mesh, n, len(mesh.distinct)))
    frames, crops = list(frames), list(crops)
    mtcnn_tree, frcnn_tree, facenet_tree = seeded_params(0, 2.0), frcnn_params(0), facenet_params(5)
    mtcnn_boxes = lambda r: [d[:, :4] for d in r]
    frcnn_boxes = lambda r: r[0]
    # name, wrapper, batch, precision of the holds, boxes of a result (None:
    # embeddings), whether the whole-batch match is held, kernels launched
    cases = (
        ("mtcnn", lambda **kw: MtcnnDetector(params=mtcnn_tree, bf16=True, **kw), frames,
         "default", mtcnn_boxes, True, ("pnet_level", "pool_crops")),
        ("frcnn bf16", lambda **kw: FrcnnDetector(params=frcnn_tree, bf16=True, **kw), frames,
         "default", frcnn_boxes, False, ("roi_align",)),
        ("frcnn f32", lambda **kw: FrcnnDetector(params=frcnn_tree, **kw), frames,
         "highest", frcnn_boxes, True, ()),
        ("facenet", lambda **kw: FaceNetEncoder(params=facenet_tree, device_resize=True, **kw),
         crops, "highest", None, True, ("resize_normalize",)))
    for name, make, batch, prec, boxes, held, kernels_run in cases:
        single, sharded = make(device=dev0), make(mesh=mesh)
        with config.precision_scope(prec):
            got = sharded(batch)
            per_block = _joined([single(blk) for blk in split_rows(batch, mesh)])
            want = single(batch)
        assert _identical(got, per_block), "%s: sharded != single device per block" % name
        if boxes is None:
            diff = float(np.abs(got - want).max())
            log("   %s: %d embeddings equal to the single device's on each shard's block; "
                "max|diff| %.3g to one call on the whole batch ('%s')" % (name, len(got), diff, prec))
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            shares = [min(matched_share(g, w), matched_share(w, g))
                      for g, w in zip(boxes(got), boxes(want))]
            log("   %s: detections per image %s equal to the single device's on each shard's "
                "block; matched at IoU >= 0.99 to one call on the whole batch: %s ('%s')"
                % (name, [len(b) for b in boxes(got)], ["%.3f" % v for v in shares], prec))
            if held:
                assert_same_boxes(boxes(got), boxes(want), name)
        if kernels_run:
            with config.precision_scope("default"):
                ms = {tag: ms_per_call(lambda w=w: w(batch)) for tag, w in
                      (("sharded", sharded), ("single", single))}
                counts = {tag: launches_of(lambda w=w: w(batch)) for tag, w in
                          (("sharded", sharded), ("single", single))}
            log("   %s: ms per batch of %d ('default'): sharded min %.2f / mean %.2f, "
                "single device min %.2f / mean %.2f" % (name, len(batch), *ms["sharded"],
                                                        *ms["single"]))
            for k in kernels_run:
                got_n, want_n = counts["sharded"][k], counts["single"][k]
                log("   %s: %s launches, one call: sharded %d (%s per shard), single %d"
                    % (name, k, got_n, got_n / n, want_n))
                assert want_n > 0 and got_n == n * want_n, (name, k, got_n, want_n)
        del single, sharded
    with config.precision_scope("highest"):
        t = torch.from_numpy(x)
        (gm, gi), (wm, wi) = (D.dedup_cosine(t, mesh=mesh), D.dedup_cosine(t.to(dev0)))
        np.testing.assert_allclose(gm.cpu().numpy(), wm.cpu().numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gi.cpu().numpy(), wi.cpu().numpy())
        (gl, gc, _), (wl, wc, _) = (kmeans_fit(x, 3, mesh=mesh), kmeans_fit(x, 3, device=dev0))
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-5)
        gs, ws = (CSC.silhouette_score(x, wl, 3, mesh=mesh),
                  CSC.silhouette_score(x, wl, 3, device=dev0))
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
        ms = {}
        for tag, kw in (("sharded", {"mesh": mesh}), ("single", {"device": dev0})):
            ms[tag] = (ms_per_call(lambda: D.dedup_cosine(t, **kw) if "mesh" in kw
                                   else D.dedup_cosine(t.to(dev0))),
                       ms_per_call(lambda: kmeans_fit(x, 3, **kw)),
                       ms_per_call(lambda: CSC.silhouette_score(x, wl, 3, **kw)))
    log("   ops on %d x %d ('highest'): dedup max|mins diff| %.3g, argmins equal; K-means "
        "k=3 labels equal, max|centre diff| %.3g; silhouette %.6f vs %.6f"
        % (x.shape[0], x.shape[1], float((gm.cpu() - wm.cpu()).abs().max()),
           float(np.abs(gc - wc).max()), gs, ws))
    for k, op in enumerate(("dedup_cosine", "kmeans_fit k=3", "silhouette_score")):
        log("   %s ms: sharded min %.2f / mean %.2f, single device min %.2f / mean %.2f"
            % (op, *ms["sharded"][k], *ms["single"][k]))


def other_device_calls(frames):
    """4v: on cuda:1 while the calling thread's current device is cuda:0,
    every kernel against its plain version on cuda:1 (K1-K3 through
    ``full_forward``'s f32 cascade and the plain engines, K4 and K5
    directly) and ``MtcnnDetector(device="cuda:1", bf16=True)`` against the
    same detector on cuda:0."""
    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.models import mtcnn as M
    from videotofaces_tpu_torch.models.wrappers import MtcnnDetector
    from videotofaces_tpu_torch.ops import resize_kernel as RK
    from videotofaces_tpu_torch.ops import roi_align as RA

    d1 = torch.device("cuda", 1)
    with torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        f1 = torch.from_numpy(np.stack(frames)).to(d1)
        model = M.MTCNN.from_jax(seeded_params(0, 2.0)).to(d1).eval()
        with config.precision_scope("highest"), torch.no_grad():
            n0 = read_launches()
            got = M.full_forward(model, f1, minsize=MINSIZE)
            with plain_engines():
                want = M.full_forward(model, f1, minsize=MINSIZE)
        torch.cuda.synchronize(d1)
        n1 = read_launches()
        assert n1["pnet_level"] > n0["pnet_level"] and n1["pool_crops"] > n0["pool_crops"]
        assert torch.equal(got[3].sum(1), want[3].sum(1)) and got[3].sum() > 0
        crops = encoder_crops(4, 16)
        pk, sz = RK.pack_images(crops)
        pk, sz = torch.from_numpy(pk).to(d1), torch.from_numpy(sz).to(d1)
        torch.testing.assert_close(RK.resize_normalize(pk, sz, 160, 1 / 128.0, 127.5),
                                   RK.resize_normalize_plain(pk, sz, 160, 1 / 128.0, 127.5),
                                   rtol=0, atol=1e-5)
        rng = np.random.default_rng(3)
        fmaps = [torch.from_numpy(rng.normal(0, 1, (1, h, w, 256)).astype(np.float32)).to(d1)
                 for h, w in ((48, 84), (24, 42), (12, 21), (6, 11))]
        xy = rng.uniform(0, 200, (1, 64, 2))
        boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(4, 300, (1, 64, 2))],
                                                -1).astype(np.float32)).to(d1)
        valid = torch.ones((1, 64), dtype=torch.bool, device=d1)
        amax = max(float(f.abs().max()) for f in fmaps)
        torch.testing.assert_close(RA.roi_align_fpn(fmaps, boxes, valid)[0],
                                   RA.roi_align_fpn_plain(fmaps, boxes, valid),
                                   rtol=1e-5, atol=1e-5 * amax)
        dets = [MtcnnDetector(device=d, params=seeded_params(0, 2.0), bf16=True)
                for d in ("cuda:1", "cuda:0")]
        got, want = (det(list(frames)) for det in dets)
        assert_same_boxes([d[:, :4] for d in got], [d[:, :4] for d in want], "mtcnn cuda:1")
        assert torch.cuda.current_device() == 0
    log("   every kernel launched on cuda:1 from a thread whose current device is "
        "cuda:0 equals its plain version there; MtcnnDetector(device='cuda:1') equals "
        "the detector on cuda:0 (%s detections)" % [len(d) for d in got])


# -- multi-host jobs (4w, 4x): host processes started from this script ---------

MH_TIMEOUT = 600   # seconds a host process may take


def mh_videos(root, seeds=(31, 37, 41), b=4, fps=4.0):
    """Three small synthetic 1080p videos (``b`` frames each, one sample per
    frame at ``video_step`` 1 / fps), different seeds so that no face
    repeats across them. Returns their directory."""
    vids = osp.join(root, "vids")
    os.makedirs(vids)
    for k, seed in enumerate(seeds):
        write_video(osp.join(vids, "v%d.mp4" % (k + 1)), seeded_frames(seed, b=b), fps)
    return vids


def host_order(src_dir, dst_dir, hosts=2, link=os.symlink):
    """Link (or copy, with ``link=shutil.copyfile``) the sorted files of
    ``src_dir`` into ``dst_dir`` under names whose sorted order is the
    order a job of ``hosts`` hosts gathers their rows in: host 0's
    round-robin share, then host 1's. Keeping the earlier face (the hash and
    embedding dedup) and the K-means++ draw depend on that order, so the
    single-process run that the hosts are held to sees the rows as they do."""
    os.makedirs(dst_dir)
    names = sorted(os.listdir(src_dir))
    for h in range(hosts):
        for k, name in enumerate(names[h::hosts]):
            link(osp.join(src_dir, name), osp.join(dst_dir, "%d%04d_%s" % (h, k, name)))
    return dst_dir


def faces_by_label(root):
    """After clustering: {label: sorted face-file bytes}."""
    faces = osp.join(root, "faces")
    out = {}
    for lbl in sorted(os.listdir(faces)):
        d = osp.join(faces, lbl)
        if osp.isdir(d):
            out[lbl] = sorted(open(osp.join(d, f), "rb").read() for f in os.listdir(d))
    return out


def merged_hosts(roots, want):
    """The hosts' faces by label, merged, for the labels of ``want``."""
    got = [faces_by_label(r) for r in roots]
    assert set().union(*got) <= set(want), (sorted(set().union(*got)), sorted(want))
    return {lbl: sorted(sum((g.get(lbl, []) for g in got), [])) for lbl in want}


def mh_factories(style, params_npz):
    """``video_to_faces``'s model factories for 4w / 4x: MTCNN (bf16) +
    FaceNet (``device_resize``) on the parameters saved beside
    ``params_npz`` (live), or the seeded R-CNN (bf16) of a missing
    checkpoint + ViT-B16 (``device_resize``) on the saved ``vit_params``
    (anime)."""
    from videotofaces_tpu_torch.pipeline.detection import get_detector_model
    from videotofaces_tpu_torch.pipeline.grouping import get_encoder_model
    from videotofaces_tpu_torch.utils.weights import load_params

    if style == "anime":
        vit = load_params(params_npz + ".vit.npz")
        return patched_factories(
            get_detector_model=lambda s, det, d: get_detector_model(s, det, d, bf16=True),
            get_encoder_model=lambda s, enc, d: get_encoder_model(
                s, enc, d, params=vit, device_resize=True))
    det_params = load_params(params_npz + ".mtcnn.npz")
    enc_params = load_params(params_npz + ".facenet.npz")
    return patched_factories(
        get_detector_model=lambda s, det, d: get_detector_model(
            s, det, d, params=det_params, bf16=True),
        get_encoder_model=lambda s, enc, d: get_encoder_model(
            s, enc, d, params=enc_params, device_resize=True))


def mh_job(style, mode, input_path, out_dir):
    """One ``video_to_faces`` job of 4w / 4x (the style's defaults but the
    MTCNN detector for live and a 1 / 4 s video step)."""
    from videotofaces_tpu_torch import video_to_faces

    os.makedirs(out_dir, exist_ok=True)
    kw = dict(det_model="mtcnn") if style == "live" else {}
    video_to_faces(input_path=input_path, out_dir=out_dir, mode=mode, style=style,
                   video_step=0.25, **kw)


def grouping_ops_digests(dev, n=2048):
    """sha256 of the embedding-dedup Gram's (min, argmin), the K-means fit
    (labels, centers, inertia) and the silhouette on ``n`` x 512 seeded
    embeddings on ``dev``: every host of a job must compute them bit for
    bit alike."""
    import hashlib

    import torch

    from videotofaces_tpu_torch.ops import cluster_scores as CSC
    from videotofaces_tpu_torch.ops import distances as D
    from videotofaces_tpu_torch.ops.kmeans import kmeans_fit

    x = unit_blobs(8, n)
    mins, inds = D.dedup_cosine(torch.from_numpy(x).to(dev))
    labels, centers, inertia = kmeans_fit(x, 8, device=dev)
    sil = CSC.silhouette_score(x, labels, 8, device=dev)

    def digest(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]

    return {"dedup": digest(mins.cpu().numpy(), inds.cpu().numpy()),
            "kmeans": digest(labels, centers, np.float64(inertia)),
            "silhouette": digest(np.float64(sil))}


def mh_host_main(spec):
    """One host of a 4w / 4x job, in its own process (``chip_smoke.py
    --mh-host SPEC``): joins the gloo group when the spec names one, runs
    each job of the spec on the card, and prints one ``MH_HOST {...}`` line:
    per job the wall seconds, the kernel launches and the ms of each
    all-gather; with ``ops``, the grouping ops' digests."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.parallel import multihost as MH

    dist = None
    if spec.get("gloo"):
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method="file://" + spec["gloo"],
                                rank=spec["rank"], world_size=spec["world"])
    gathers = []
    allgather = MH.allgather_rows

    def timed_allgather(*args, **kw):
        t0 = time.perf_counter()
        try:
            return allgather(*args, **kw)
        finally:
            gathers.append((time.perf_counter() - t0) * 1e3)

    MH.allgather_rows = timed_allgather
    config.set_precision("highest")
    out = {"index": MH.process_info()[0], "jobs": []}
    try:
        with mh_factories(spec["style"], spec.get("params")):
            for mode, input_path, out_dir in spec["jobs"]:
                del gathers[:]
                reset_launches()
                t0 = time.perf_counter()
                mh_job(spec["style"], mode, input_path, out_dir)
                torch.cuda.synchronize()
                out["jobs"].append({"mode": mode, "wall_s": time.perf_counter() - t0,
                                    "launches": read_launches(), "gather_ms": list(gathers)})
        if spec.get("ops"):
            out["ops"] = grouping_ops_digests(torch.device("cuda"))
        # the transport alone: once the hosts are lined up by one gather,
        # five gathers of 1,024 embedding rows (512 float32) and names each
        rows = np.random.default_rng(out["index"]).normal(size=(1024, 512)).astype(np.float32)
        names = ["h%02d_%06d_0.jpg" % (out["index"], k) for k in range(len(rows))]
        allgather(rows[:1], names[:1])
        out["transport_ms"] = []
        for _ in range(5):
            t0 = time.perf_counter()
            g, _ = allgather(rows, names)
            out["transport_ms"].append((time.perf_counter() - t0) * 1e3)
        assert g.shape == (1024 * MH.process_info()[1], 512)
    finally:
        if dist is not None:
            dist.barrier()
            dist.destroy_process_group()
    log("MH_HOST " + json.dumps(out))
    return 0


def run_hosts(specs, envs):
    """Start one ``--mh-host`` process per spec at once, wait for all (the
    rest are killed when one fails or outlives ``MH_TIMEOUT``), and return
    their ``MH_HOST`` records."""
    procs = []
    for spec, env in zip(specs, envs):
        full = {k: v for k, v in os.environ.items() if not k.startswith("V2F_")}
        full.update(env)
        procs.append(subprocess.Popen(
            [sys.executable, osp.abspath(__file__), "--mh-host", json.dumps(spec)],
            env=full, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log("   host %d exited with %d; its output ends:\n%s"
                % (i, p.returncode, "\n".join(o.splitlines()[-40:])))
    assert all(p.returncode == 0 for p in procs), "a host process failed"
    return [json.loads(next(ln for ln in o.splitlines()
                            if ln.startswith("MH_HOST "))[len("MH_HOST "):]) for o in outs]


def log_hosts(records, single_s):
    """Per host and job: the wall (the host's models built cold, where this
    process's are warm), the ms of each all-gather (waiting for the slower
    host included) and the launches; then the transport alone."""
    for r in records:
        for job in r["jobs"]:
            g = job["gather_ms"]
            log("   host %d, %s: %.2f s wall (one process: %.2f s); %d all-gathers, "
                "ms each %s; launches %s"
                % (r["index"], job["mode"], job["wall_s"], single_s[job["mode"]], len(g),
                   ", ".join("%.2f" % v for v in g), job["launches"]))
        log("   host %d, transport alone: ms per all-gather of 1,024 x 512 float32 rows "
            "per host %s" % (r["index"], ", ".join("%.2f" % v for v in r["transport_ms"])))


def multihost_live(dev):
    """4w: ``video_to_faces(mode="full", style="live", det_model="mtcnn")``
    over three 1080p videos by two host processes on cuda:0 through a
    shared gather directory, held to one process over the same videos in
    the hosts' gather order; then the grouping ops' digests of both hosts
    against this process's."""
    import uuid

    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.utils.weights import flatten, save_npz

    config.set_precision("highest")   # the process default, as in the hosts
    with tempfile.TemporaryDirectory() as tmp:
        vids = mh_videos(tmp)
        params = osp.join(tmp, "params")
        save_npz(params + ".mtcnn.npz", flatten(seeded_params(0, 2.0)))
        save_npz(params + ".facenet.npz", flatten(facenet_params(5, dev)))
        with mh_factories("live", params):
            reset_launches()
            t0 = time.perf_counter()
            mh_job("live", "full", host_order(vids, osp.join(tmp, "ordered")),
                   osp.join(tmp, "single"))
            torch.cuda.synchronize()
            single_s = {"full": time.perf_counter() - t0}
            log("   one process: %.2f s, launches %s" % (single_s["full"], read_launches()))
        want = faces_by_label(osp.join(tmp, "single"))
        env = dict(V2F_PROCESS_COUNT="2", V2F_GATHER_DIR=osp.join(tmp, "gather"),
                   V2F_RUN_ID=uuid.uuid4().hex)
        specs = [dict(style="live", params=params, ops=True,
                      jobs=[("full", vids, osp.join(tmp, "h%d" % i))]) for i in range(2)]
        records = run_hosts(specs, [dict(env, V2F_PROCESS_INDEX=str(i)) for i in range(2)])
        log_hosts(records, single_s)
        got = merged_hosts([osp.join(tmp, "h%d" % i) for i in range(2)], want)
        log("   faces by label: one process %s, two hosts %s"
            % ({k: len(v) for k, v in want.items()}, {k: len(v) for k, v in got.items()}))
        assert sum(map(len, want.values())) > 9, "too few faces to hold the hosts to"
        assert got == want, "the hosts' merged output differs from one process's"
        for r in records:
            launches = r["jobs"][0]["launches"]
            for name in ("pnet_level", "pool_crops", "resize_normalize"):
                assert launches[name] > 0, "host %d launched no %s" % (r["index"], name)
        ops = grouping_ops_digests(dev)
        log("   grouping ops digests: this process %s, hosts %s"
            % (ops, [r["ops"] for r in records]))
        assert all(r["ops"] == ops for r in records), "the hosts' grouping ops differ"


def multihost_anime(dev):
    """4x: the anime defaults (Faster R-CNN bf16 + ViT-B16 ``device_resize``,
    its embeddings centered by ``vit_params``) in ``mode="full"`` over three 1080p videos by two host processes on
    cuda:0 in a gloo process group, then ``mode="grouping"`` by the same
    hosts over one shared folder of the first run's faces; each held to one
    process over the same inputs in the hosts' gather order."""
    import shutil

    import torch

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.utils.weights import flatten, save_npz

    config.set_precision("highest")   # the process default, as in the hosts
    with tempfile.TemporaryDirectory() as tmp:
        vids = mh_videos(tmp, seeds=(43, 47, 53))
        params = osp.join(tmp, "params")
        save_npz(params + ".vit.npz", flatten(vit_params(dev)))
        with mh_factories("anime", params):
            single_s = {}
            reset_launches()
            t0 = time.perf_counter()
            mh_job("anime", "full", host_order(vids, osp.join(tmp, "ordered")),
                   osp.join(tmp, "single"))
            torch.cuda.synchronize()
            single_s["full"] = time.perf_counter() - t0
            log("   one process, full: %.2f s, launches %s"
                % (single_s["full"], read_launches()))
            want = faces_by_label(osp.join(tmp, "single"))
            # grouping mode: the first run's faces in one flat folder, shared by
            # the hosts; the single process lists them in the hosts' order
            flat = osp.join(tmp, "flat")
            os.makedirs(flat)
            for lbl, files in want.items():
                for k, data in enumerate(files):
                    with open(osp.join(flat, "%s_%04d.jpg" % (lbl, k)), "wb") as f:
                        f.write(data)
            shutil.copytree(flat, osp.join(tmp, "shared", "faces"))
            host_order(flat, osp.join(tmp, "gsingle", "faces"), link=shutil.copyfile)
            t0 = time.perf_counter()
            mh_job("anime", "grouping", None, osp.join(tmp, "gsingle"))
            torch.cuda.synchronize()
            single_s["grouping"] = time.perf_counter() - t0
        gwant = faces_by_label(osp.join(tmp, "gsingle"))
        specs = [dict(style="anime", params=params, gloo=osp.join(tmp, "gloo_init"),
                      rank=i, world=2,
                      jobs=[("full", vids, osp.join(tmp, "h%d" % i)),
                            ("grouping", None, osp.join(tmp, "shared"))])
                 for i in range(2)]
        records = run_hosts(specs, [{}, {}])
        log_hosts(records, single_s)
        got = merged_hosts([osp.join(tmp, "h%d" % i) for i in range(2)], want)
        log("   full, faces by label: one process %s, two hosts %s"
            % ({k: len(v) for k, v in want.items()}, {k: len(v) for k, v in got.items()}))
        assert sum(map(len, want.values())) > 9, "too few faces to hold the hosts to"
        assert got == want, "the hosts' merged output differs from one process's"
        gotg = faces_by_label(osp.join(tmp, "shared"))
        log("   grouping, faces by label: one process %s, two hosts %s"
            % ({k: len(v) for k, v in gwant.items()}, {k: len(v) for k, v in gotg.items()}))
        assert gotg == gwant, "the hosts' grouping differs from one process's"
        for r in records:
            launches = r["jobs"][0]["launches"]
            for name in ("roi_align", "resize_normalize"):
                assert launches[name] > 0, "host %d launched no %s" % (r["index"], name)
            assert r["jobs"][1]["launches"]["resize_normalize"] > 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    root = osp.dirname(osp.abspath(__file__))
    if not osp.isdir(osp.join(root, "videotofaces_tpu_torch")):
        print("chip_smoke: the videotofaces_tpu_torch package is not beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    from videotofaces_tpu_torch import config
    from videotofaces_tpu_torch.models import mtcnn as M
    from videotofaces_tpu_torch.ops import _cuda
    from videotofaces_tpu_torch.ops import crops_kernel as CK
    from videotofaces_tpu_torch.ops import pnet_kernel as PK

    dev = torch.device("cuda")
    kinds = torch.cuda.get_device_name(0)
    card = card_line()
    kernels = {}
    sass = None

    with phase("1. card"):
        log("torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
                                              sys.version.split()[0]))
        log("device: %s, count %d" % (kinds, torch.cuda.device_count()))
        log("nvidia-smi: " + card)

    with phase("2. build"):
        secs = _cuda.build_all()
        log("built %s in %.1f s (wall, parallel nvcc)" % (", ".join(_cuda.SOURCES), secs))
        for src in _cuda.SOURCES:
            for fn, regs, spills in ptxas_summary(_cuda.ptxas_log(src)):
                log("   %s %s: %s; %s" % (src, fn, regs, spills))
        sass = sass_instruction_counts(_cuda._target("pnet_level.cu"))
        if sass is None:
            log("   cuobjdump not in the toolkit: tensor-core instructions not counted")
        else:
            for fn, ops in sass.items():
                log("   pnet_level.cu SASS %s: %s" % (fn, ops))
            tc_ops = sum(sum(ops.values()) for fn, ops in sass.items() if "pnet_tc" in fn)
            assert tc_ops > 0, "the bf16 PNet kernel holds no tensor-core instruction"

    frames_np = seeded_frames(7)
    frames = torch.from_numpy(frames_np).to(dev)
    scales, sizes = M.scale_pyramid(H, W, MINSIZE)
    log("pyramid: %d levels, largest %s, smallest %s" % (len(sizes), sizes[0], sizes[-1]))
    # kernel checks: heads not scaled, so reg is O(1) and a wrong reg shows
    kmodel = M.MTCNN.from_jax(seeded_params(0, 2.0, reg_scale=1.0)).to(dev).eval()

    with phase("3a. pnet_level kernel vs plain (bf16 pyramid, f32 levels)"):
        ms = plain_ms = bnd = 0.0
        err = {"reg": 0.0, "prob": 0.0}
        reg_max = 0.0
        nbytes_all = ops_all = 0
        checks = []
        w16 = PK.pack_weights(kmodel.pnet, torch.bfloat16).to(dev)
        for level_hw in sizes:
            got = PK.pnet_level(frames, level_hw, w16, torch.bfloat16)
            want = PK.pnet_level_plain(frames, level_hw, w16, torch.bfloat16)
            e = pnet_errors(got, want)
            checks.append((got, want, e))
            err = {k: max(err[k], e[k]) for k in err}
            reg_max = max(reg_max, e["reg_max"])
            k_ms = cuda_ms(lambda: PK.pnet_level(frames, level_hw, w16, torch.bfloat16), 5)
            p_ms = cuda_ms(lambda: PK.pnet_level_plain(frames, level_hw, w16,
                                                       torch.bfloat16), 2)
            nb, ops = pnet_work(level_hw)
            bl, by = bound_ms(nb, ops, "bfloat16")
            ms, plain_ms, bnd = ms + k_ms, plain_ms + p_ms, bnd + bl
            nbytes_all, ops_all = nbytes_all + nb, ops_all + ops
            log("   bf16 level %-12s kernel %8.3f ms  plain %8.3f ms  bound %.4f ms (%s)  "
                "max|err| reg %.3g (max|reg| %.3g) prob %.3g"
                % (level_hw, k_ms, p_ms, bl, by, e["reg"], e["reg_max"], e["prob"]))
        for got, want, e in checks:
            check_pnet(got, want, "bfloat16", e)
        del checks
        _, by_all = bound_ms(nbytes_all, ops_all, "bfloat16")
        log("   bf16 pyramid: kernel %.3f ms, plain %.3f ms, bound %.4f ms per batch; "
            "%.1f GFLOP, %.3f GB; max|reg| %.3g" % (ms, plain_ms, bnd, ops_all / 1e9,
                                                   nbytes_all / 1e9, reg_max))
        assert reg_max > 100 * TOLS["bfloat16"]["atol"], "reg too small to check"
        kernels["pnet_level"] = dict(
            name="pnet_level", route="cuda",
            source="videotofaces_tpu_torch/csrc/pnet_level.cu",
            replaces="videotofaces_tpu/ops/pallas_pnet.py:540 (pnet_level_fused); "
                     "videotofaces_tpu/ops/pallas_pnet.py:457 (pnet_level)",
            launches=None, max_abs_err=max(err.values()), ms=ms, plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by_all, library_ms=None, max_abs_err_by_output=err,
            tensor_core_sass=None if sass is None else {
                fn: ops for fn, ops in sass.items() if "pnet_tc" in fn},
            tol={"prob": TOLS["bfloat16"], "reg": dict(rtol=TOLS["bfloat16"]["rtol"],
                                                       atol="%g x max|reg|"
                                                       % TOLS["bfloat16"]["atol"])},
            shape="B=2 1080p min face 5, %d levels, bf16" % len(sizes))
        w32 = PK.pack_weights(kmodel.pnet, torch.float32).to(dev)
        for level_hw in [(2593, 4609), (924, 1643)]:
            got = PK.pnet_level(frames, level_hw, w32, torch.float32)
            want = PK.pnet_level_plain(frames, level_hw, w32, torch.float32)
            e = pnet_errors(got, want)
            k_ms = cuda_ms(lambda: PK.pnet_level(frames, level_hw, w32, torch.float32), 3)
            p_ms = cuda_ms(lambda: PK.pnet_level_plain(frames, level_hw, w32,
                                                       torch.float32), 2)
            bl, by = bound_ms(*pnet_work(level_hw, dtype="float32"), "float32")
            log("   f32  level %-12s kernel %8.3f ms  plain %8.3f ms  bound %.4f ms (%s)  "
                "max|err| reg %.3g (max|reg| %.3g) prob %.3g (tol %s)"
                % (level_hw, k_ms, p_ms, bl, by, e["reg"], e["reg_max"], e["prob"],
                   TOLS["float32"]))
            check_pnet(got, want, "float32", e)

    with phase("3b. pool_crops kernel vs plain (stage-2 and stage-3 slot tables)"):
        rng = np.random.default_rng(11)
        ms = plain_ms = bnd = 0.0
        err = 0.0
        nbytes_all = ops_all = 0
        for n, size in [(B * 1024, 24), (B * 256, 48)]:
            slots_np = crop_slots(rng, n)
            slots = torch.from_numpy(slots_np).to(dev)
            got = CK.pool_crops(frames, slots, size)
            want = CK.pool_crops_plain(frames, slots, size)
            torch.cuda.synchronize()
            # exact: int32 window sums and one IEEE division on both sides
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            e = (got - want).abs().max().item()
            err = max(err, e)
            k_ms = cuda_ms(lambda: CK.pool_crops(frames, slots, size), 10)
            p_ms = cuda_ms(lambda: CK.pool_crops_plain(frames, slots, size), 3)
            nb, ops = crops_work(slots_np, size)
            bl, by = bound_ms(nb, ops, "float32")
            ms, plain_ms, bnd = ms + k_ms, plain_ms + p_ms, bnd + bl
            nbytes_all, ops_all = nbytes_all + nb, ops_all + ops
            log("   N=%d out %d (%d live): kernel %.3f ms  plain %.3f ms  bound %.4f ms "
                "(%s)  max|err| %.3g" % (n, size, int(slots_np[:, 5].sum()), k_ms, p_ms,
                                         bl, by, e))
        kernels["pool_crops"] = dict(
            name="pool_crops", route="cuda",
            source="videotofaces_tpu_torch/csrc/pool_crops.cu",
            replaces="videotofaces_tpu/ops/pallas_crops.py:129 (adaptive_pool_crops)",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
            bound_by=bound_ms(nbytes_all, ops_all, "float32")[1], library_ms=None,
            tol=dict(rtol=0, atol=0),
            shape="N=2048 out 24 + N=512 out 48 on B=2 1080p")

    with phase("3c. resize_normalize kernel vs plain (N=128, out 160, pack 256)"):
        from videotofaces_tpu_torch.ops import resize_kernel as RK

        n, out, scale, mean = 128, 160, 1 / 128.0, 127.5
        packed_np, sizes_np = RK.pack_images(encoder_crops(3, n), 256)
        packed = torch.from_numpy(packed_np).to(dev)
        hw = torch.from_numpy(sizes_np).to(dev)
        got = RK.resize_normalize(packed, hw, out, scale, mean)
        want = RK.resize_normalize_plain(packed, hw, out, scale, mean)
        lib = library_resize(packed, sizes_np, out, scale, mean)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lib_err = (lib - got).abs().max().item()
        # the same tap weights on both sides; sums differ by FMA contraction
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        k_ms = cuda_ms(lambda: RK.resize_normalize(packed, hw, out, scale, mean), 50, 3)
        p_ms = cuda_ms(lambda: RK.resize_normalize_plain(packed, hw, out, scale, mean), 5)
        l_ms = cuda_ms(lambda: library_resize(packed, sizes_np, out, scale, mean), 5)
        nb, ops = resize_work(sizes_np, out)
        bl, by = bound_ms(nb, ops, "float32")
        log("   kernel %.4f ms  plain %.3f ms  library (F.interpolate loop) %.3f ms  "
            "bound %.4f ms (%s; %.1f MB, %.3f GFLOP)  max|kernel-plain| %.3g (tol atol "
            "1e-5)  max|library-kernel| %.3g (not gated)"
            % (k_ms, p_ms, l_ms, bl, by, nb / 1e6, ops / 1e9, err, lib_err))
        # the ViT's input: out 128, (x - 127.5) / 127.5
        v_scale = 1 / 127.5
        got = RK.resize_normalize(packed, hw, 128, v_scale, mean)
        want = RK.resize_normalize_plain(packed, hw, 128, v_scale, mean)
        torch.cuda.synchronize()
        v_err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        v_ms = cuda_ms(lambda: RK.resize_normalize(packed, hw, 128, v_scale, mean), 50, 3)
        v_plain = cuda_ms(lambda: RK.resize_normalize_plain(packed, hw, 128, v_scale, mean), 5)
        v_bound, _ = bound_ms(*resize_work(sizes_np, 128), "float32")
        log("   ViT input (out 128, affine 1/127.5 about 127.5): kernel %.4f ms  plain %.3f ms  "
            "bound %.4f ms  max|kernel-plain| %.3g (tol atol 1e-5)"
            % (v_ms, v_plain, v_bound, v_err))
        kernels["resize_normalize"] = dict(
            name="resize_normalize", route="cuda",
            source="videotofaces_tpu_torch/csrc/resize_normalize.cu",
            replaces="videotofaces_tpu/ops/pallas_resize.py:62 (resize_normalize_chw_u8)",
            launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bl,
            bound_by=by, library_ms=l_ms, library_max_abs_diff=lib_err,
            tol=dict(rtol=0, atol=1e-5),
            shape="N=128 crops 141-180 x 180 in 256 slots -> 160 px",
            vit_out128=dict(ms=v_ms, plain_ms=v_plain, bound_ms=v_bound, max_abs_err=v_err))

    with phase("3d. roi_align kernel vs plain (B=2 x 1,000 rois on a 1080p pyramid, "
               "f32 and bf16)"):
        from videotofaces_tpu_torch.models import rcnn as R
        from videotofaces_tpu_torch.ops import roi_align as RA
        from videotofaces_tpu_torch.ops import roi_align_kernel as RAK
        from videotofaces_tpu_torch.ops.anchors import get_priors

        ftree = frcnn_params(0)
        nh, nw = R.resized_shape(H, W)
        canvas = R.canvas_shape(nh, nw)
        priors = [torch.from_numpy(p).to(dev) for p in get_priors(
            canvas, R.frcnn_bases(), loc="corner", concat=False)]
        synth = torch.from_numpy(roi_synthetic_boxes()).to(dev)
        for fn, regs, spills in ptxas_summary(_cuda.ptxas_log("roi_align.cu")):
            log("   roi_align.cu %s: %s; %s" % (fn, regs, spills))
        roi_entry = None
        for dtype, prec in ((torch.float32, "highest"), (torch.bfloat16, "default")):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            model = R.AnimeFRCNN.from_jax(ftree).to(dev).to(dtype).eval()
            with torch.no_grad(), config.precision_scope(prec):
                x = R.preprocess(frames, (nh, nw), canvas,
                                 dtype if dtype == torch.bfloat16 else None)
                pyramid, regs, logs = model.body(x)
                used = torch.tensor([[nh, nw]] * B, dtype=torch.float32, device=dev)
                boxes, valid, _ = R.rpn_proposals([t.float() for t in regs],
                                                  [t.float() for t in logs], priors, used)
            del model
            # the lowest-scoring slots of each image carry the synthetic boxes
            boxes = boxes.clone()
            boxes[:, -len(synth):] = synth
            valid = valid.clone()
            valid[:, -len(synth):] = True
            fmaps = [p.permute(0, 2, 3, 1).contiguous() for p in pyramid[:4]]
            del pyramid, regs, logs
            levels = RA.assign_fpn_levels(boxes).to(torch.int32)
            got = RA.roi_align_fpn(fmaps, boxes, valid)[0]
            want = RA.roi_align_fpn_plain(fmaps, boxes, valid)
            torch.cuda.synchronize()
            amax = max(float(f.float().abs().max()) for f in fmaps)
            err = (got - want).abs().max().item()
            # same weights on both sides; float32 sums in another order (the
            # kernel's fma chains, cuBLAS in the plain version)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * amax)
            assert (got[~valid] == 0).all()
            del got, want
            k_ms = cuda_ms(lambda: RAK.roi_align_cuda(fmaps, boxes, levels, valid, RA.STRIDES),
                           20, 3)
            p_ms = cuda_ms(lambda: RA.roi_align_fpn_plain(fmaps, boxes, valid), 2)
            esize = 2 if dtype == torch.bfloat16 else 4
            nb, ops = roi_work(boxes, valid, [tuple(f.shape[1:3]) for f in fmaps], 256, esize)
            bl, by = bound_ms(nb, ops, "float32")       # float32 arithmetic either way
            counts = torch.bincount(levels[valid].flatten().long(), minlength=4).tolist()
            log("   %s: %d valid rois (per level P2..P5 %s), kernel %.4f ms  plain %.3f ms  "
                "bound %.4f ms (%s; %.1f MB, %.2f GFLOP)  max|kernel-plain| %.3g "
                "(max|feature| %.3g; tol rtol 1e-5, atol 1e-5 x max|feature|)"
                % (name, int(valid.sum()), counts, k_ms, p_ms, bl, by, nb / 1e6, ops / 1e9,
                   err, amax))
            entry = dict(
                name="roi_align", route="cuda",
                source="videotofaces_tpu_torch/csrc/roi_align.cu",
                replaces="videotofaces_tpu/ops/pallas_roialign.py:153 (roi_align_patches); "
                         "launched by videotofaces_tpu/ops/roi_align.py:431 "
                         "(roi_align_multilevel_pallas)",
                launches=None, max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bl,
                bound_by=by, library_ms=None,
                tol=dict(rtol=1e-5, atol="1e-5 x max|feature|"),
                shape="B=2 x 1000 rois (seeded RPN proposals + %d synthetic) on a "
                      "768x1344 canvas, P2 192x336 .. P5 24x42, C=256, %s"
                      % (len(synth), name))
            if dtype == torch.bfloat16:
                entry["f32"] = roi_entry
                roi_entry = entry
            else:
                roi_entry = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bl, max_abs_err=err)
            del fmaps
        kernels["roi_align"] = roi_entry

    det = None
    with phase("4a. main path: MtcnnDetector(bf16=True), precision default"):
        from videotofaces_tpu_torch.models.wrappers import MtcnnDetector

        config.set_precision("default")
        det = MtcnnDetector(params=seeded_params(0, 2.0), bf16=True)
        assert det.device.type == "cuda"
        batch = list(frames_np)
        for _ in range(2):
            det(batch)                                   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        iters, times = 5, []
        for _ in range(iters):
            t0 = time.perf_counter()
            handle = det.submit(batch)
            res = det.collect(handle)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {"pnet_level": PK.pnet_level.launches,
                    "pool_crops": CK.pool_crops.launches}
        log("   cascade ms per batch of %d: mean %.2f, min %.2f, all %s"
            % (B, np.mean(times), np.min(times), ["%.2f" % t for t in times]))
        log("   launches over %d batches: %s" % (iters, launches))
        for name, n in launches.items():
            assert n > 0, "%s was not launched on the main path" % name
            kernels[name]["launches"] = n
        assert launches["pnet_level"] == iters * len(sizes)
        assert launches["pool_crops"] == iters * 2
        (out, _), _ = handle
        counts = {k: v.tolist() for k, v in out[4].items()}
        log("   counts: %s" % counts)
        for k in ("stage1", "stage1_scale_max", "stage1_select_overflow", "cross_in",
                  "stage2", "stage2_crop_dropped", "stage3", "stage3_crop_dropped"):
            assert k in counts, k
        assert counts["stage2"][0] > 0 and counts["stage3"][0] > 0, "stages 2-3 saw no candidates"
        assert len(res) == B
        for r in res:
            assert r.ndim == 2 and r.shape[1] == 5 and np.isfinite(r).all()
        log("   detections per frame: %s" % [len(r) for r in res])
        profile_batch(det, batch)


    with phase("4b. cascade f32 'highest': kernel path vs plain path on the card"):
        m32 = M.MTCNN.from_jax(seeded_params(0, 2.0)).to(dev).eval()
        with config.precision_scope("highest"), torch.no_grad():
            n0 = PK.pnet_level.launches, CK.pool_crops.launches
            got = M.full_forward(m32, frames, minsize=MINSIZE)
            assert PK.pnet_level.launches > n0[0] and CK.pool_crops.launches > n0[1]
            with plain_engines():
                n1 = PK.pnet_level.launches, CK.pool_crops.launches
                want = M.full_forward(m32, frames, minsize=MINSIZE)
                assert (PK.pnet_level.launches, CK.pool_crops.launches) == n1
        gv, wv = got[3].cpu(), want[3].cpu()
        log("   valid per image: kernel path %s, plain path %s" % (gv.sum(1).tolist(),
                                                                wv.sum(1).tolist()))
        log("   counts kernel %s" % {k: v.tolist() for k, v in got[4].items()})
        log("   counts plain  %s" % {k: v.tolist() for k, v in want[4].items()})
        assert torch.equal(gv.sum(1), wv.sum(1)), "valid counts differ"
        assert gv.sum() > 0, "no final detections"
        for i in range(B):
            gb, wb = got[0][i].cpu()[gv[i]], want[0][i].cpu()[wv[i]]
            gs, ws = got[1][i].cpu()[gv[i]], want[1][i].cpu()[wv[i]]
            log("   image %d: max|box diff| %.3g, max|score diff| %.3g"
                % (i, (gb - wb).abs().max().item(), (gs - ws).abs().max().item()))
            torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(gb, wb, rtol=1e-3, atol=2e-2)

    with phase("4c. video_to_faces(mode='detection', style='live', det_model='mtcnn')"):
        from videotofaces_tpu_torch import video_to_faces

        with tempfile.TemporaryDirectory() as tmp:
            path = osp.join(tmp, "synthetic_1080p.mp4")
            fps = 4.0
            write_video(path, seeded_frames(13, b=8), fps)
            out_dir = osp.join(tmp, "out")
            os.makedirs(out_dir)
            from videotofaces_tpu_torch.hostio import frame_schedule, open_reader

            reader = open_reader(path, "opencv")
            nframes = len(frame_schedule(reader.length, reader.fps, 1.0 / fps, None)[0])
            reader.close()
            reset_launches()
            t0 = time.perf_counter()
            video_to_faces(input_path=path, out_dir=out_dir, mode="detection",
                           style="live", det_model="mtcnn", video_step=1.0 / fps,
                           det_batch_size=4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log("   %d sampled frames in %.2f s: %.2f frames/s (model load and "
                "first-batch warm-up included)" % (nframes, wall, nframes / wall))
            log("   launches: pnet_level %d, pool_crops %d"
                % (PK.pnet_level.launches, CK.pool_crops.launches))
            assert PK.pnet_level.launches > 0 and CK.pool_crops.launches > 0
            assert osp.isdir(osp.join(out_dir, "faces"))

    with phase("4d. FaceNetEncoder(batch_size=128), precision default: host cv2 vs "
               "device_resize (K5), 1,024 crops"):
        from videotofaces_tpu_torch.models.wrappers import FaceNetEncoder
        from videotofaces_tpu_torch.ops import resize_kernel as RK

        config.set_precision("default")
        tree = facenet_params(5)
        crops = encoder_crops(4, 1024)
        embs, rates = {}, {}
        for name, kw in (("host_cv2", {}), ("device_resize", {"device_resize": True})):
            enc = FaceNetEncoder(params=tree, batch_size=128, **kw)
            enc(crops[:128])                                   # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            embs[name] = np.concatenate([enc(crops[i:i + 128])
                                         for i in range(0, len(crops), 128)])
            wall = time.perf_counter() - t0
            launches = read_launches()
            rates[name] = len(crops) / wall
            log("   %-13s %8.1f faces/s (%d crops in %.3f s, host resize/pack, H2D, "
                "forward, D2H); launches %s" % (name, rates[name], len(crops), wall, launches))
            if kw:
                assert launches["resize_normalize"] == len(crops) // 128, launches
                kernels["resize_normalize"]["launches"] = launches["resize_normalize"]
                pk, sz = RK.pack_images(crops[:128])
                x = RK.resize_normalize(torch.from_numpy(pk).to(dev),
                                        torch.from_numpy(sz).to(dev), 160, 1 / 128.0, 127.5)
                with torch.inference_mode():
                    fwd = cuda_ms(lambda: enc.model(x), 10, 2)
                log("   forward alone, batch 128 staged on the card: %.3f ms (%.1f faces/s)"
                    % (fwd, 128e3 / fwd))
                profile_batch(enc, crops[:128])
            else:
                assert launches["resize_normalize"] == 0, launches
        diff = np.abs(embs["host_cv2"] - embs["device_resize"]).max()
        cos = (embs["host_cv2"] * embs["device_resize"]).sum(1)
        log("   embeddings host vs device_resize: max|diff| %.4g, min cosine %.6f "
            "(cv2 fixed-point vs float bilinear, TF32)" % (diff, cos.min()))
        assert embs["device_resize"].shape == (1024, 512)
        assert np.isfinite(embs["device_resize"]).all()
        np.testing.assert_allclose(np.linalg.norm(embs["device_resize"], axis=1), 1, atol=1e-3)

    with phase("4e. kmeans_fit + scores on the card, k=2..9, 4,096 x 512"):
        from videotofaces_tpu_torch.ops import cluster_scores as CS
        from videotofaces_tpu_torch.ops.kmeans import kmeans_fit

        x = unit_blobs(6, 4096)
        with config.precision_scope("highest"):
            kmeans_fit(x, 2, device=dev)                       # warm-up
            for k in range(2, 10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                labels, _, inertia = kmeans_fit(x, k, random_state=0, device=dev)
                t1 = time.perf_counter()
                sil = CS.silhouette_score(x, labels, k, device=dev)
                ch = CS.calinski_harabasz_score(x, labels, k, device=dev)
                db = CS.davies_bouldin_score(x, labels, k, device=dev)
                t2 = time.perf_counter()
                cpu_labels = kmeans_fit(x, k, random_state=0, device="cpu")[0]
                log("   k=%d kmeans %.2f ms, scores %.2f ms (silhouette %.5f, CH %.2f, "
                    "DB %.4f), inertia %.3f, labels equal to CPU: %s"
                    % (k, (t1 - t0) * 1e3, (t2 - t1) * 1e3, sil, ch, db, inertia,
                       np.array_equal(labels, cpu_labels)))
                np.testing.assert_array_equal(labels, cpu_labels)

    with phase("4f. full path by stages on a synthetic 1080p video: seeded MTCNN, "
               "FaceNet device_resize, dedup, clustering"):
        from videotofaces_tpu_torch.pipeline.detection import detect_faces
        from videotofaces_tpu_torch.pipeline.dupes import remove_dupes_overall
        from videotofaces_tpu_torch.pipeline.grouping import (cluster_faces, encode_faces,
                                                              get_encoder_model)
        from videotofaces_tpu_torch.specs import (BoxCriteria, ClusterSpec, FrameSampling,
                                                  OutputLayout)

        from videotofaces_tpu_torch.models.wrappers import MtcnnDetector

        with tempfile.TemporaryDirectory() as tmp:
            path = osp.join(tmp, "synthetic_1080p.mp4")
            write_video(path, seeded_frames(17, b=8), 4.0)
            layout = OutputLayout(osp.join(tmp, "out"))
            det = MtcnnDetector(params=seeded_params(0, 2.0))
            enc = get_encoder_model("live", "facenet_vgg", None, batch_size=128,
                                    device_resize=True, params=facenet_params(5, dev))
            reset_launches()
            t0 = time.perf_counter()
            paths = detect_faces([path], det, FrameSampling(step=0.25),
                                 BoxCriteria(batch_size=4, min_size=20, min_border=0),
                                 layout, 8)
            t1 = time.perf_counter()
            feats = encode_faces(paths, enc, 128, None)
            t2 = time.perf_counter()
            feats, kept = remove_dupes_overall(feats, paths, "enc", 0.25, layout)
            t3 = time.perf_counter()
            cluster_faces(kept, feats, ClusterSpec(list(range(2, 10))), layout.root)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            launches = read_launches()
            groups = sorted(d for d in os.listdir(layout.faces_dir)
                            if osp.isdir(osp.join(layout.faces_dir, d)))
            log("   %d faces detected (%.2f s), encoded (%.2f s), %d survive the "
                "embedding dedup (%.2f s), clustered into %s (%.2f s); launches %s"
                % (len(paths), t1 - t0, t2 - t1, len(kept), t3 - t2, groups, t4 - t3,
                   launches))
            assert len(kept) > 9, "too few faces survive to try every k"
            assert len(groups) >= 2 and all(
                os.listdir(osp.join(layout.faces_dir, g)) for g in groups)
            for name in ("pnet_level", "pool_crops", "resize_normalize"):
                assert launches[name] > 0, "%s was not launched on the full path" % name

    with phase("4g. video_to_faces(mode='full', style='live', det_model='mtcnn')"):
        from videotofaces_tpu_torch import video_to_faces

        with tempfile.TemporaryDirectory() as tmp:
            path = osp.join(tmp, "synthetic_1080p.mp4")
            write_video(path, seeded_frames(13, b=8), 4.0)
            out_dir = osp.join(tmp, "out")
            os.makedirs(out_dir)
            reset_launches()
            t0 = time.perf_counter()
            video_to_faces(input_path=path, out_dir=out_dir, mode="full", style="live",
                           det_model="mtcnn", video_step=0.25)
            torch.cuda.synchronize()
            log("   full mode run in %.2f s; launches %s"
                % (time.perf_counter() - t0, read_launches()))
            assert read_launches()["pnet_level"] > 0
            assert osp.isdir(osp.join(out_dir, "faces"))

    with phase("4h. main path: FrcnnDetector(bf16=True), precision default, B=2 1080p"):
        from videotofaces_tpu_torch.models.wrappers import FrcnnDetector
        from videotofaces_tpu_torch.ops import roi_align_kernel as RAK

        config.set_precision("default")
        det = FrcnnDetector(params=frcnn_params(0), bf16=True)
        assert det.device.type == "cuda"
        batch = list(frames_np)
        for _ in range(2):
            det(batch)                                   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        iters, times = 5, []
        for _ in range(iters):
            t0 = time.perf_counter()
            boxes, scores, classes = det.collect(det.submit(batch))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        log("   detector ms per batch of %d: mean %.2f, min %.2f, all %s"
            % (B, np.mean(times), np.min(times), ["%.2f" % t for t in times]))
        log("   launches over %d batches: %s" % (iters, launches))
        assert launches["roi_align"] == iters, launches
        kernels["roi_align"]["launches"] = launches["roi_align"]
        log("   detections per frame: %s, scores %s" % (
            [len(b) for b in boxes], ["%.3f-%.3f" % (s.min(), s.max()) for s in scores if len(s)]))
        assert len(boxes) == B and all(len(b) > 0 for b in boxes)
        for b, sc in zip(boxes, scores):
            assert b.shape[1] == 4 and np.isfinite(b).all() and np.isfinite(sc).all()
        profile_batch(det, batch)
        del det

    with phase("4i. FrcnnDetector f32 'highest': kernel path vs plain path on the card"):
        from videotofaces_tpu_torch.models.wrappers import FrcnnDetector
        from videotofaces_tpu_torch.ops import roi_align_kernel as RAK

        det32 = FrcnnDetector(params=frcnn_params(0))
        batch = list(frames_np)
        with config.precision_scope("highest"):
            n0 = RAK.roi_align_cuda.launches
            got = det32(batch)
            assert RAK.roi_align_cuda.launches == n0 + 1
            with plain_roi_align():
                want = det32(batch)
            assert RAK.roi_align_cuda.launches == n0 + 1
        del det32
        log("   detections per frame: kernel path %s, plain path %s"
            % ([len(b) for b in got[0]], [len(b) for b in want[0]]))
        for i in range(B):
            assert len(got[0][i]) == len(want[0][i]) > 0, "valid counts differ"
            log("   image %d: max|box diff| %.3g px, max|score diff| %.3g"
                % (i, np.abs(got[0][i] - want[0][i]).max(),
                   np.abs(got[1][i] - want[1][i]).max()))
            np.testing.assert_allclose(got[1][i], want[1][i], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got[0][i], want[0][i], rtol=1e-4, atol=1e-2)

    with phase("4j. VitEncoder B16 (batch 128), precision default: host cv2 vs "
               "device_resize (K5 at out 128), 1,024 crops"):
        from videotofaces_tpu_torch.models.wrappers import VitEncoder
        from videotofaces_tpu_torch.ops import resize_kernel as RK

        config.set_precision("default")
        crops = encoder_crops(8, 1024)
        embs = {}
        for name, kw in (("host_cv2", {}), ("device_resize", {"device_resize": True})):
            enc = VitEncoder(batch_size=128, **kw)
            enc(crops[:128])                                   # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            embs[name] = np.concatenate([enc(crops[i:i + 128])
                                         for i in range(0, len(crops), 128)])
            wall = time.perf_counter() - t0
            launches = read_launches()
            log("   %-13s %8.1f faces/s (%d crops in %.3f s, host resize/pack, H2D, "
                "forward, D2H); launches %s" % (name, len(crops) / wall, len(crops), wall,
                                                launches))
            if kw:
                assert launches["resize_normalize"] == len(crops) // 128, launches
                pk, sz = RK.pack_images(crops[:128])
                x = RK.resize_normalize(torch.from_numpy(pk).to(dev),
                                        torch.from_numpy(sz).to(dev), 128, 1 / 127.5, 127.5)
                with torch.inference_mode():
                    fwd = cuda_ms(lambda: enc.model(x), 10, 2)
                log("   forward alone, batch 128 staged on the card: %.3f ms (%.1f faces/s)"
                    % (fwd, 128e3 / fwd))
                profile_batch(enc, crops[:128])
            else:
                assert launches["resize_normalize"] == 0, launches
        diff = np.abs(embs["host_cv2"] - embs["device_resize"]).max()
        log("   embeddings host vs device_resize: max|diff| %.4g (cv2 fixed-point vs float "
            "bilinear, TF32)" % diff)
        assert embs["device_resize"].shape == (1024, 768)
        assert np.isfinite(embs["device_resize"]).all()

    with phase("4k. video_to_faces() with its defaults (anime: Faster R-CNN + ViT-B16, "
               "full) on a synthetic 1080p video"):
        from videotofaces_tpu_torch import video_to_faces

        with tempfile.TemporaryDirectory() as tmp:
            path = osp.join(tmp, "synthetic_1080p.mp4")
            write_video(path, seeded_frames(19, b=16), 4.0)
            out_dir = osp.join(tmp, "out")
            os.makedirs(out_dir)
            reset_launches()
            t0 = time.perf_counter()
            video_to_faces(input_path=path, out_dir=out_dir)
            torch.cuda.synchronize()
            launches = read_launches()
            faces = [f for _, _, fs in os.walk(osp.join(out_dir, "faces")) for f in fs
                     if f.endswith(".jpg")]
            log("   full mode run in %.2f s: %d face images kept; launches %s"
                % (time.perf_counter() - t0, len(faces), launches))
            assert launches["roi_align"] > 0, launches
            assert faces, "the anime path found no faces"

    with phase("4l. main path: YoloDetector(bf16=True), precision default, B=2 1080p"):
        from videotofaces_tpu_torch.models.wrappers import YoloDetector

        config.set_precision("default")
        batch = list(frames_np)
        for label, params in (("seeded weights, the worst case", yolo_params(0)),
                              ("bench.py::_sparsify recipe, objectness biases -4",
                               yolo_params(0, obj_shift=-4.0))):
            log("   -- %s" % label)
            det = YoloDetector(params=params, bf16=True)
            assert det.device.type == "cuda"
            for _ in range(2):
                det(batch)                                   # warm-up
            torch.cuda.synchronize()
            reset_launches()
            iters, times = 5, []
            for _ in range(iters):
                t0 = time.perf_counter()
                boxes, scores, classes = det.collect(det.submit(batch))
                times.append((time.perf_counter() - t0) * 1e3)
            launches = read_launches()
            log("   detector ms per batch of %d: mean %.2f, min %.2f, all %s"
                % (B, np.mean(times), np.min(times), ["%.2f" % t for t in times]))
            log("   launches over %d batches: %s (the YOLO path runs no hand-written "
                "kernel)" % (iters, launches))
            passing, entering, d, ops = yolo_candidates(det, batch)
            log("   candidates per image: %s of D = %d pass the thresholds; valid slots "
                "entering NMS %s" % (passing, d, entering))
            bnd, by = bound_ms(sum(p.numel() * p.element_size() for p in det.model.parameters())
                               + frames_np.nbytes, ops, "bfloat16")
            log("   bound: %.1f GFLOP of convolutions per batch -> %.4f ms (%s; bf16 peak)"
                % (ops / 1e9, bnd, by))
            log("   detections per frame: %s, scores %s" % (
                [len(b) for b in boxes],
                ["%.3f-%.3f" % (s.min(), s.max()) for s in scores if len(s)]))
            assert len(boxes) == B and d == 13167
            for b, sc in zip(boxes, scores):
                assert b.shape[1] == 4 and np.isfinite(b).all() and np.isfinite(sc).all()
            profile_batch(det, batch, top=10)
            del det

    with phase("4m. YoloDetector f32 'highest': the card vs the CPU, max_side 320, "
               "B=2 1080p"):
        from videotofaces_tpu_torch.models.wrappers import YoloDetector

        params = yolo_params(0)
        batch = list(frames_np)
        with config.precision_scope("highest"):
            got = YoloDetector(params=params, max_side=320)(batch)
            t0 = time.perf_counter()
            want = YoloDetector(device="cpu", params=params, max_side=320)(batch)
            log("   CPU detector: %.2f s for the batch" % (time.perf_counter() - t0))
        for i in range(B):
            gb, wb = got[0][i], want[0][i]
            shares = matched_share(gb, wb), matched_share(wb, gb)
            n = min(len(gb), len(wb))
            log("   image %d: %d detections on the card, %d on the CPU; matched at IoU >= "
                "0.99: %.3f / %.3f; max|score diff| over the first %d %.3g"
                % (i, len(gb), len(wb), shares[0], shares[1], n,
                   np.abs(got[1][i][:n] - want[1][i][:n]).max()))
            assert len(wb) > 5 and abs(len(gb) - len(wb)) <= 1
            assert min(shares) >= 0.98, shares

    with phase("4n. video_to_faces(style='live') with its defaults (YOLOv3 + FaceNet-VGG, "
               "full) on a synthetic 1080p video"):
        from videotofaces_tpu_torch import video_to_faces
        from videotofaces_tpu_torch.pipeline.detection import get_detector_model
        from videotofaces_tpu_torch.pipeline.grouping import get_encoder_model

        config.set_precision("highest")
        det_params = yolo_params(0, obj_shift=2.0, cls_shift=2.0, reg_scale=0.6)
        enc_params = facenet_params(5, dev)
        with tempfile.TemporaryDirectory() as tmp, patched_factories(
                get_detector_model=lambda style, det, d: get_detector_model(
                    style, det, d, params=det_params),
                get_encoder_model=lambda style, enc, d: get_encoder_model(
                    style, enc, d, params=enc_params)):
            path = osp.join(tmp, "synthetic_1080p.mp4")
            write_video(path, seeded_frames(23, b=16), 4.0)
            out_dir = osp.join(tmp, "out")
            os.makedirs(out_dir)
            reset_launches()
            t0 = time.perf_counter()
            video_to_faces(input_path=path, out_dir=out_dir, style="live")
            torch.cuda.synchronize()
            faces_dir = osp.join(out_dir, "faces")
            groups = sorted(g for g in os.listdir(faces_dir)
                            if osp.isdir(osp.join(faces_dir, g)))
            faces = [f for _, _, fs in os.walk(faces_dir) for f in fs if f.endswith(".jpg")]
            log("   live full run in %.2f s: %d face images kept in groups %s; launches %s"
                % (time.perf_counter() - t0, len(faces), groups, read_launches()))
            assert faces, "the live path found no faces"
            assert len(groups) >= 2 and all(os.listdir(osp.join(faces_dir, g))
                                            for g in groups), "faces were not clustered"

    with phase("4o. served anime defaults over TCP: FaceService(style='anime', "
               "device_resize) — Faster R-CNN + ViT-B16 — through ServeClient"):
        served_anime_tcp(root, list(frames_np), dev, kernels)

    with phase("4p. served MTCNN over HTTP: FaceService(style='live', det_model='mtcnn', "
               "bf16, device_resize), PNG-encoded 1080p frames"):
        served_mtcnn_http(list(frames_np), dev)

    with phase("4q. concurrent clients: live defaults (YOLOv3 + FaceNet) on a unix socket, "
               "4 clients x 3 extract, one in-process caller under precision 'highest'"):
        served_concurrent(dev)

    with phase("4r. training: finetune_yolo_full / finetune_yolo_head (YOLOv3), batch 8, "
               "max_side 608, 16 synthetic 1080p frames, 'default' and 'highest'"):
        train_yolo(dev)

    with phase("4s. training: finetune_facenet at 160 px, batch 32, bank_size 0 and 256"):
        train_facenet(dev)

    with phase("4t. training: ViTClassifier B16 at 128 px, batch 64, remat False and True"):
        train_vit(dev)

    with phase("4u. mesh of two shards on cuda:0: MTCNN and R-CNN (bf16) on the 4a batch, "
               "FaceNet device_resize on 128 crops, dedup / K-means / silhouette on "
               "4,096 x 512, each sharded vs one device"):
        from videotofaces_tpu_torch.pipeline.mesh_auto import default_mesh, resolve_mesh

        log("   torch.cuda.device_count() %d, default_mesh() %r, mesh=\"auto\" %r"
            % (torch.cuda.device_count(), default_mesh(), resolve_mesh("auto")))
        assert resolve_mesh("auto") is None   # phases 4a-4t ran on one device
        sharded_vs_single([dev, dev], frames_np, encoder_crops(4, 128), unit_blobs(6, 4096))

    with phase("4v. two cards: the same on a cuda:0 + cuda:1 mesh, and every kernel on "
               "cuda:1 called from a thread whose current device is cuda:0"):
        if torch.cuda.device_count() < 2:
            log("   skipped: this host has %d CUDA device(s); 4v needs two"
                % torch.cuda.device_count())
        else:
            sharded_vs_single(["cuda:0", "cuda:1"], frames_np, encoder_crops(4, 128),
                              unit_blobs(6, 4096))
            other_device_calls(frames_np)

    with phase("4w. two hosts on cuda:0, shared gather directory: video_to_faces(mode="
               "'full', style='live', det_model='mtcnn') over three 1080p videos vs one "
               "process"):
        multihost_live(dev)

    with phase("4x. two hosts on cuda:0, gloo process group: the anime defaults, "
               "mode='full' then mode='grouping' on a shared folder, vs one process"):
        multihost_anime(dev)

    if failures:
        print("chip_smoke: %d phase(s) failed:\n  %s" % (len(failures),
                                                        "\n  ".join(failures)),
              file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kinds,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mh-host"]:
        sys.exit(mh_host_main(json.loads(sys.argv[2])))
    sys.exit(main())
