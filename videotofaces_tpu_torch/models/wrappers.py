"""User-facing model wrappers (counterpart of
videotofaces_tpu/models/wrappers.py): the MTCNN, YOLOv3 and Faster R-CNN
detectors and the FaceNet and ViT encoders.

Weights resolution: converted .npz checkpoints from <repo>/weights, in the
JAX package's layout (``python -m videotofaces_tpu_torch.convert_weights``
writes them), turned into the modules' state dicts by
``utils/weights.*_from_jax``. When a
checkpoint is absent, the wrapper falls back to seeded random weights (an
explicit ``torch.Generator``) with a loud note — every compute path still
runs, only the predictions are untrained.

Every model call (``submit`` of a detector, ``__call__`` of an encoder)
runs inside ``config.model_call()``: under the TF32 flags of the calling
thread's precision, whatever scope another thread holds.

``mesh=`` (parallel/mesh.py) shards every wrapper data-parallel, as the JAX
package's ``mesh=`` does: the batch is rounded up to a multiple of the
mesh's size (``_round_batch``; the padding repeats the last frame and is
dropped), cut into one equal block per shard, and each block runs on its
device (``map_shards``, one shard after another), with one copy of the
module per distinct device of the mesh. The results are joined in shard
order, so a sharded call returns what the single-device call returns: every
capacity buffer of the detectors is per image.
"""

import copy
import os.path as osp

import numpy as np
import torch

from .. import config
from ..parallel.mesh import gather_rows, map_shards, pad_to_multiple, split_rows
from ..utils import weights as W
from ..utils.profiling import span


def _resolve_checkpoint(checkpoint):
    """The parameter tree of <weights_dir>/<checkpoint>.npz, or None (with a
    note) when the file is absent."""
    path = osp.join(W.weights_dir(), checkpoint + ".npz")
    if osp.isfile(path):
        print("Using weights from: " + path)
        return W.load_params(path)
    print("NOTE: no converted weights at %s — using seeded random init "
          "(run python -m videotofaces_tpu_torch.convert_weights with the torch checkpoint "
          "for real weights)" % path)
    return None


def _to_pinned(t):
    """Start a non-blocking copy of a device tensor into pinned host memory
    on the current stream; the caller waits on an event recorded after."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _round_batch(bs, mesh):
    """The batch size rounded up to a multiple of the mesh's shards."""
    return bs if mesh is None else pad_to_multiple(bs, mesh.shape["data"])


def _to_device(arr, device):
    """A host array on ``device``: on the card from a pinned buffer, by a
    non-blocking copy on the current stream."""
    x = torch.from_numpy(arr)
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_join(trees):
    """Shards' output trees (tuples and dicts of host tensors with the batch
    first) joined on the batch axis, in shard order."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_join([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_tree_join(parts) for parts in zip(*trees, strict=True))
    return torch.cat(trees)


class _Shards(list):
    """The per-shard output trees of a sharded ``submit``."""


class _Replicas:
    """Placement shared by the five wrappers: the devices of the shards
    (the mesh's, or the one ``device``), one copy of the module on each
    distinct device (``self.models``; shards on one device share it),
    ``self.device`` the first device and ``self.model`` its module."""

    def _place(self, model, device, mesh):
        if mesh is not None and device is not None:
            raise ValueError("pass device= or mesh=, not both (got %r and %r)"
                             % (device, mesh))
        self.mesh = mesh
        self.devices = (mesh.shards if mesh is not None
                        else (config.resolve_device(device),))
        self.device = self.devices[0]
        distinct = mesh.distinct if mesh is not None else self.devices
        # copies first, while ``model`` is still on the host
        self.models = {d: (model if k == len(distinct) - 1 else copy.deepcopy(model))
                       for k, d in enumerate(distinct)}
        for d, m in self.models.items():
            m.to(d).eval()
        self.model = self.models[self.device]

    def _run(self, fn, *parts):
        """``fn(device, *blocks)`` on every shard, under one
        ``config.model_call()`` taken here and inference mode."""
        with config.model_call(), torch.inference_mode():
            return map_shards(self.mesh, fn, *parts, device=self.device)

    def _submit_shards(self, frames, forward):
        """Start a batch of uint8 ``frames``: padded to the batch size (the
        ``detect:h2d`` span), each shard's block goes to its device from a
        pinned host buffer, ``forward(model, x)`` runs on that device's
        current stream, and its outputs start their copy back into pinned
        buffers, with one event recorded after them (``detect:d2h``).
        Returns the handle ``collect`` takes and the count of real frames."""
        with span("detect:h2d"):
            arr, n = pad_batch(frames, _round_batch(self.batch_size or len(frames), self.mesh))
            xs = self._run(lambda dev, block: _to_device(block, dev),
                           split_rows(arr, self.mesh))

        def shard(dev, x):
            out = forward(self.models[dev], x)
            with span("detect:d2h"):
                if dev.type != "cuda":
                    return out, None
                host = _tree_map(_to_pinned, out)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                return host, done

        shards = self._run(shard, xs)
        if len(shards) == 1:
            return shards[0], n
        return (_Shards(out for out, _ in shards), [done for _, done in shards]), n


def _landed(out, done):
    """A submitted batch's outputs once their copies have landed (the
    ``detect:wait`` span): one shard's tree as it is, the trees of several
    joined in shard order."""
    with span("detect:wait"):
        if isinstance(out, _Shards):
            for d in done:
                if d is not None:
                    d.synchronize()
            return _tree_join(out)
        if done is not None:
            done.synchronize()
        return out


def pad_batch(frames, batch_size):
    """Stack a list of same-shape frames, padding to ``batch_size`` by repeating
    the last frame (results for the padding are dropped)."""
    n = len(frames)
    arr = np.stack(frames)
    if n < batch_size:
        arr = np.concatenate([arr, np.repeat(arr[-1:], batch_size - n, axis=0)])
    return arr, n


class MtcnnDetector(_Replicas):
    """Live-action face detector; reference API parity with RealMTCNN
    (mtcnn.py:312-326): __call__(list of BGR frames) -> list of [n, 5] numpy
    arrays (x1, y1, x2, y2, score), optionally with landmarks.

    ``device``: None means the CUDA card and raises when there is none;
    pass ``"cpu"`` to run the plain versions of the kernels on the CPU.
    ``mesh``: shard every batch over a ``parallel.mesh.Mesh`` instead (see
    the module docstring). ``params``: the JAX package's MTCNN parameter
    tree (numpy arrays), used instead of a checkpoint. ``bf16``: store the
    nets in bfloat16 and run the cascade in bfloat16, as the JAX detector's
    flag does. ``crop_engine`` is accepted for compatibility with the JAX
    package; whatever it names, the stage-2/3 crops run through the CUDA
    kernel K3 on the card (the function of every JAX engine)."""

    def __init__(self, device=None, min_face_size=5, checkpoint="mtcnn_joined",
                 batch_size=None, caps=None, params=None, mesh=None, bf16=False,
                 crop_engine=None):
        from . import mtcnn as M

        print("Initializing MTCNN model for live-action face detection")
        if crop_engine not in _CROP_ENGINES:
            raise ValueError("unknown crop_engine %r (valid: %s)"
                             % (crop_engine, _CROP_ENGINES))
        self.M = M
        self.compute_dtype = torch.bfloat16 if bf16 else None
        self.minsize = min_face_size
        self.caps = caps or M.Caps()
        self.batch_size = batch_size
        if params is None:
            params = _resolve_checkpoint(checkpoint)
        model = M.MTCNN.seeded(0) if params is None else M.MTCNN.from_jax(params)
        if bf16:
            model = model.to(torch.bfloat16)
        self._place(model, device, mesh)

    def submit(self, frames):
        """Start a batch: frames go to the card from a pinned host buffer
        (non-blocking copy), the cascade runs on the current stream, and its
        results start their copy back into pinned buffers; ``collect`` waits
        for them. The cascade's NMS loops sync with the host, so submit
        returns once the device work is queued past the last of them."""
        return self._submit_shards(list(frames), lambda model, x: self.M.full_forward(
            model, x, minsize=self.minsize, caps=self.caps,
            compute_dtype=self.compute_dtype))

    def collect(self, handle, return_landmarks=False):
        out, n = handle
        out = _landed(*out)
        boxes, scores, lmk, valid = (t.numpy() for t in out[:4])
        counts = {k: v.numpy() for k, v in out[4].items()}
        # warn whenever survivors exceed the NEXT fixed-capacity buffer;
        # pre1 caps each SCALE independently, so stage 1 is judged by its
        # per-scale peak
        for stage, cap_name in [("stage1_scale_max", "pre1"),
                                ("cross_in", "cross"),
                                ("stage2", "stage3"),
                                ("stage3", "out")]:
            cap = getattr(self.caps, cap_name)
            seen = int(counts[stage].max())
            if seen > cap:
                print("WARNING: MTCNN %s survivors exceeded buffer capacity "
                      "(%d > %d); results may drop low-scoring faces. "
                      "Increase Caps.%s."
                      % (stage.replace("_scale_max", " (per-scale)")
                         .replace("cross_in", "cross-scale input"),
                         seen, cap, cap_name))
        res, ldm = [], []
        for i in range(n):
            v = valid[i]
            res.append(np.concatenate([boxes[i][v], scores[i][v][:, None]], axis=1))
            ldm.append(lmk[i][v])
        if return_landmarks:
            return res, ldm
        return res

    def __call__(self, frames, return_landmarks=False):
        return self.collect(self.submit(frames), return_landmarks)


class _BoxDetectorBase(_Replicas):
    """Shared submit / collect for detectors whose forward returns (boxes,
    scores, classes, valid, *counters): YOLO's one counter
    (select_overflow) or Faster R-CNN's three (select_overflow,
    roi_dropped, roi_truncated) (models/wrappers.py:86-153 of the JAX
    package). Subclasses provide ``_name``, ``_counter_warnings`` (one
    "%s ... %d" text per counter, filled with the name and the batch max),
    ``_resized_hw(h, w)`` and ``_forward(model, x_u8, h, w)``."""

    _counter_warnings = ()

    def _resized_hw(self, h, w):
        raise NotImplementedError

    def _forward(self, model, x, h, w):
        raise NotImplementedError

    def submit(self, frames):
        """Start a batch: optional host cv2 resize, padding to the batch
        size, a non-blocking copy to the card from a pinned buffer, the
        forward on the current stream, and the results' copies back into
        pinned buffers; ``collect`` waits for them."""
        frames = list(frames)
        h, w = frames[0].shape[:2]
        if self.host_resize:
            import cv2

            nh, nw = self._resized_hw(h, w)
            frames = [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
                      for f in frames]
        return self._submit_shards(frames, lambda model, x: self._forward(model, x, h, w))

    def collect(self, handle):
        """Wait for a batch; returns per-image (boxes [n, 4], scores [n],
        classes [n]) numpy lists, and warns when a capacity counter is set."""
        out, n = handle
        boxes, scores, classes, valid, *counters = (t.numpy() for t in _landed(*out))
        for counter, text in zip(counters, self._counter_warnings, strict=True):
            worst = int(counter.max())
            if worst > 0:
                print("WARNING: " + text % (self._name, worst))
        out_b, out_s, out_c = [], [], []
        for i in range(n):
            v = valid[i]
            out_b.append(boxes[i][v])
            out_s.append(scores[i][v])
            out_c.append(classes[i][v])
        return out_b, out_s, out_c

    def __call__(self, frames):
        return self.collect(self.submit(frames))


class YoloDetector(_BoxDetectorBase):
    """Live-action face detector; reference API parity with RealYOLO
    (yolo.py:179-191): __call__(list of BGR frames) -> (boxes, scores,
    classes) as per-image numpy lists.

    ``device``: None means the CUDA card and raises when there is none;
    ``"cpu"`` runs on the CPU; ``mesh`` shards every batch instead (see the
    module docstring). ``params``: the JAX package's {"backbone",
    "neck", "head"} tree (numpy arrays), used instead of a checkpoint.
    ``max_side``: the keep-ratio resize's longer side (608). ``host_resize``:
    resize with cv2 on the host (bit parity with the reference).
    ``bf16``: parameters and the network in bfloat16 with the uint8-canvas
    preprocess, as the JAX detector's flag. ``s2d`` is accepted for
    compatibility with the JAX package and ignored: its space-to-depth stem
    computes the same taps in a TPU blocking."""

    _name = "YOLO"
    _counter_warnings = ("%s candidate selection dropped up to %d candidate(s) per "
                         "image (batch max).",)

    def __init__(self, device=None, checkpoint="yolov3_wider", max_side=608,
                 batch_size=None, params=None, mesh=None, host_resize=False, bf16=False,
                 s2d=None):
        from . import yolo as Y

        print("Initializing YOLOv3 model for live-action face detection")
        del s2d
        self.Y = Y
        self.max_side = max_side
        self.host_resize = host_resize
        self.compute_dtype = torch.bfloat16 if bf16 else None
        self.batch_size = batch_size
        if params is None:
            params = _resolve_checkpoint(checkpoint)
        model = Y.YOLOv3.seeded(0) if params is None else Y.YOLOv3.from_jax(params)
        if bf16:
            model = model.to(torch.bfloat16)
        self._place(model, device, mesh)
        self._geom = {}

    def _resized_hw(self, h, w):
        return self.Y.resized_shape(h, w, self.max_side)

    def _geometry(self, h, w, device=None):
        """(resized size, canvas, priors [D, 4], strides [D, 1] on ``device``,
        default ``self.device``) of an h x w frame, computed once per frame
        size for every device of the wrapper."""
        if (h, w) not in self._geom:
            nh, nw = self._resized_hw(h, w)
            canvas = self.Y.canvas_shape(nh, nw)
            priors, strides = self.Y.flat_priors_and_strides(canvas)
            self._geom[(h, w)] = ((nh, nw), canvas, {
                d: (torch.from_numpy(priors).to(d), torch.from_numpy(strides).to(d))
                for d in self.models})
        resized, canvas, on = self._geom[(h, w)]
        return (resized, canvas) + on[device or self.device]

    def _forward(self, model, x, h, w):
        resized, canvas, priors, strides = self._geometry(h, w, x.device)
        return self.Y.full_forward(model, x, resized, canvas, priors, strides,
                                   orig_hw=(h, w) if self.host_resize else None,
                                   compute_dtype=self.compute_dtype)


class FrcnnDetector(_BoxDetectorBase):
    """Anime face detector; reference API parity with AnimeFRCNN
    (rcnn.py:154-177): __call__(list of BGR frames) -> (boxes, scores,
    classes) as per-image numpy lists.

    ``device``: None means the CUDA card and raises when there is none;
    ``"cpu"`` runs the plain RoIAlign on the CPU; ``mesh`` shards every
    batch instead (see the module docstring). ``params``: the JAX
    package's {"body", "head"} tree (numpy arrays), used instead of a
    checkpoint. ``bf16``: parameters and the network in bfloat16 with the
    uint8-canvas preprocess, as the JAX detector's flag. ``roi_method`` is
    accepted for compatibility with the JAX package; whatever it says, the
    RoIAlign runs through the CUDA kernel K4 on the card (it computes the
    dense method's function, with no buckets and no window)."""

    _name = "FasterRCNN"
    _counter_warnings = (
        "%s RPN two-pass NMS may have displaced up to %d proposal(s) per image "
        "(batch max; dense detections); run in precision 'highest' for the exact NMS.",
        "%s RoIAlign dropped up to %d roi(s) per image (batch max).",
        "%s RoIAlign ran up to %d roi(s) per image (batch max) with a truncated "
        "sampling window.")

    def __init__(self, device=None, checkpoint="frcnn_anime", batch_size=None,
                 params=None, mesh=None, resize_spec=(800, 1333), proposal_cap=1000,
                 out_top=100, host_resize=False, bf16=False, roi_method=None):
        from . import rcnn as R

        print("Initializing FasterRCNN model for anime face detection")
        if roi_method not in _ROI_METHODS:
            raise ValueError("unknown roi_method %r (valid: %s)" % (roi_method, _ROI_METHODS))
        self.R = R
        self.resize_spec = resize_spec
        self.host_resize = host_resize
        self.compute_dtype = torch.bfloat16 if bf16 else None
        self.proposal_cap = proposal_cap
        self.out_top = out_top
        self.batch_size = batch_size
        self.roi_method = roi_method
        if params is None:
            params = _resolve_checkpoint(checkpoint)
        model = R.AnimeFRCNN.seeded(0) if params is None else R.AnimeFRCNN.from_jax(params)
        if bf16:
            model = model.to(torch.bfloat16)
        self._place(model, device, mesh)
        self._priors = {}

    def _resized_hw(self, h, w):
        return self.R.resized_shape(h, w, *self.resize_spec)

    def _geometry(self, h, w, device=None):
        """(resized size, canvas, per-level priors on ``device``, default
        ``self.device``) of an h x w frame, computed once per frame size
        for every device of the wrapper."""
        if (h, w) not in self._priors:
            from ..ops.anchors import get_priors

            nh, nw = self._resized_hw(h, w)
            canvas = self.R.canvas_shape(nh, nw)
            host = get_priors(canvas, self.R.frcnn_bases(), loc="corner", concat=False)
            self._priors[(h, w)] = ((nh, nw), canvas, {
                d: [torch.from_numpy(p).to(d) for p in host] for d in self.models})
        resized, canvas, on = self._priors[(h, w)]
        return resized, canvas, on[device or self.device]

    def _forward(self, model, x, h, w):
        resized, canvas, priors = self._geometry(h, w, x.device)
        return self.R.full_forward(model, x, resized, canvas, priors,
                                   out_top=self.out_top, proposal_cap=self.proposal_cap,
                                   orig_hw=(h, w) if self.host_resize else None,
                                   compute_dtype=self.compute_dtype)


# the JAX package's RoIAlign formulations; every one runs through K4 here
_ROI_METHODS = (None, "dense", "sorted", "slice", "gather", "pallas", "pallas-interpret")
_CROP_ENGINES = (None, "gather", "pallas", "pallas-interpret")


class _Encoder(_Replicas):
    """Shared encoder wrapper: resize to the model's square input (the
    cv2.blobFromImages step), normalize, forward, padded batches.
    ``__call__(list of BGR crops)`` -> [n, D] float32 numpy embeddings.

    Host path (``device_resize=False``, the default): per-crop
    ``cv2.resize(..., INTER_LINEAR)``, padding by repeating the last crop,
    a pinned non-blocking copy of the uint8 batch to the card, then BGR ->
    RGB and the affine normalization there. ``device_resize=True`` packs the
    crops on the host (``pack_images``, ``pack_size`` square slots) and
    resizes them on the card with the K5 kernel (ops/resize_kernel.py);
    numerics differ from cv2's fixed-point INTER_LINEAR by < 1 LSB.
    ``device``: None means the CUDA card and raises when there is none;
    ``mesh`` shards every batch instead (see the module docstring)."""

    def __init__(self, model, input_size, preprocess, norm_scale, norm_mean,
                 device=None, batch_size=None, mesh=None, device_resize=False,
                 pack_size=256):
        self._place(model, device, mesh)
        self.input_size = input_size
        self.preprocess = preprocess
        self.norm_scale, self.norm_mean = norm_scale, norm_mean
        self.batch_size = batch_size
        self.device_resize = device_resize
        self.pack_size = pack_size

    def _packed_blocks(self, images, bs):
        """The packed crops and their sizes, padded to ``bs`` rows."""
        from ..ops import resize_kernel as RK

        packed, sizes = RK.pack_images(images, self.pack_size)
        n = len(images)
        if n < bs:
            packed = np.concatenate([packed, np.repeat(packed[-1:], bs - n, axis=0)])
            sizes = np.concatenate([sizes, np.repeat(sizes[-1:], bs - n, axis=0)])
        return packed, sizes

    def _packed_input(self, dev, packed, sizes):
        from ..ops import resize_kernel as RK

        return RK.resize_normalize(_to_device(packed, dev), _to_device(sizes, dev),
                                   self.input_size, self.norm_scale, self.norm_mean,
                                   swap_rb=True)

    def _host_blocks(self, images, bs):
        """The cv2-resized crops, padded to ``bs`` rows."""
        import cv2

        s = self.input_size
        blobs = [cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
                 for img in images]
        return (pad_batch(blobs, bs)[0],)

    def _host_input(self, dev, arr):
        u8 = _to_device(arr, dev)
        # BGR -> RGB, affine normalize, NHWC -> NCHW
        return self.preprocess(u8.flip(-1)).permute(0, 3, 1, 2).contiguous()

    def __call__(self, images):
        images = list(images)
        n = len(images)
        bs = _round_batch(self.batch_size or n, self.mesh)
        if self.device_resize:
            blocks, make_input = self._packed_blocks(images, bs), self._packed_input
        else:
            blocks, make_input = self._host_blocks(images, bs), self._host_input

        def shard(dev, *parts):
            return self.models[dev](make_input(dev, *parts))

        out = self._run(shard, *(split_rows(b, self.mesh) for b in blocks))
        return gather_rows(out)[:n].cpu().numpy()


class FaceNetEncoder(_Encoder):
    """Live-action face embedder; parity with FaceNet (facenet.py:157-183).
    ``params``: the JAX package's InceptionResnetV1 parameter tree (numpy
    arrays), used instead of a checkpoint."""

    def __init__(self, device=None, casia=False, params=None, **kw):
        from . import facenet as FN

        src = "casia" if casia else "vgg"
        print("Initializing FaceNet %s model for live-action face encoding" % src.upper())
        if params is None:
            params = _resolve_checkpoint("facenet_" + src)
        model = (FN.InceptionResnetV1.seeded(0) if params is None
                 else FN.InceptionResnetV1.from_jax(params))
        # facenet.py:179 affine: (x - 127.5) / 128
        super().__init__(model, 160, FN.preprocess_uint8, 1 / 128.0, 127.5, device, **kw)


class VitEncoder(_Encoder):
    """Anime face embedder; parity with AnimeVIT (vit.py:105-146): ViT-B16,
    or ViT-L16 with ``large``, on 128 px crops normalized by (x - 127.5) /
    127.5. ``params``: the JAX package's ViT parameter tree (numpy arrays),
    used instead of a checkpoint."""

    def __init__(self, device=None, large=False, params=None, **kw):
        from . import vit as V

        src = "L16" if large else "B16"
        print("Initializing ViT %s model for anime face encoding" % src)
        arch = V.L16 if large else V.B16
        if params is None:
            params = _resolve_checkpoint("vit_anime_" + src.lower())
        model = V.ViT.seeded(0, **arch) if params is None else V.ViT.from_jax(params, **arch)
        # vit.py:141 affine: (x - 127.5) / 127.5
        super().__init__(model, 128, V.preprocess_uint8, 1 / 127.5, 127.5, device, **kw)
