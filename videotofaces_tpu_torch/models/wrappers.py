"""User-facing model wrappers (counterpart of
videotofaces_tpu/models/wrappers.py): the MTCNN, YOLOv3 and Faster R-CNN
detectors and the FaceNet and ViT encoders.

Weights resolution: converted .npz checkpoints from <repo>/weights, in the
JAX package's layout (see tools/convert_weights.py), turned into the
modules' state dicts by ``utils/weights.*_from_jax``. When a
checkpoint is absent, the wrapper falls back to seeded random weights (an
explicit ``torch.Generator``) with a loud note — every compute path still
runs, only the predictions are untrained.

Every model call (``submit`` of a detector, ``__call__`` of an encoder)
runs inside ``config.model_call()``: under the TF32 flags of the calling
thread's precision, whatever scope another thread holds.
"""

import os.path as osp

import numpy as np
import torch

from .. import config
from ..utils import weights as W


def _resolve_checkpoint(checkpoint):
    """The parameter tree of <weights_dir>/<checkpoint>.npz, or None (with a
    note) when the file is absent."""
    path = osp.join(W.weights_dir(), checkpoint + ".npz")
    if osp.isfile(path):
        print("Using weights from: " + path)
        return W.load_params(path)
    print("NOTE: no converted weights at %s — using seeded random init "
          "(run tools/convert_weights.py with the torch checkpoint for real weights)" % path)
    return None


def _to_pinned(t):
    """Start a non-blocking copy of a device tensor into pinned host memory
    on the current stream; the caller waits on an event recorded after."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def pad_batch(frames, batch_size):
    """Stack a list of same-shape frames, padding to ``batch_size`` by repeating
    the last frame (results for the padding are dropped)."""
    n = len(frames)
    arr = np.stack(frames)
    if n < batch_size:
        arr = np.concatenate([arr, np.repeat(arr[-1:], batch_size - n, axis=0)])
    return arr, n


class MtcnnDetector:
    """Live-action face detector; reference API parity with RealMTCNN
    (mtcnn.py:312-326): __call__(list of BGR frames) -> list of [n, 5] numpy
    arrays (x1, y1, x2, y2, score), optionally with landmarks.

    ``device``: None means the CUDA card and raises when there is none;
    pass ``"cpu"`` to run the plain versions of the kernels on the CPU.
    ``params``: the JAX package's MTCNN parameter tree (numpy arrays), used
    instead of a checkpoint. ``bf16``: store the nets in bfloat16 and run
    the cascade in bfloat16, as the JAX detector's flag does."""

    def __init__(self, device=None, min_face_size=5, checkpoint="mtcnn_joined",
                 batch_size=None, caps=None, params=None, bf16=False):
        from . import mtcnn as M

        print("Initializing MTCNN model for live-action face detection")
        self.device = config.resolve_device(device)
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
        self.model = model.to(self.device).eval()

    def submit(self, frames):
        """Start a batch: frames go to the card from a pinned host buffer
        (non-blocking copy), the cascade runs on the current stream, and its
        results start their copy back into pinned buffers; ``collect`` waits
        for them. The cascade's NMS loops sync with the host, so submit
        returns once the device work is queued past the last of them."""
        bs = self.batch_size or len(frames)
        arr, n = pad_batch(list(frames), bs)
        x = torch.from_numpy(arr)
        cuda = self.device.type == "cuda"
        if cuda:
            x = x.pin_memory().to(self.device, non_blocking=True)
        with config.model_call(), torch.inference_mode():
            out = self.M.full_forward(self.model, x, minsize=self.minsize,
                                      caps=self.caps,
                                      compute_dtype=self.compute_dtype)
        if not cuda:
            return (out, None), n
        boxes, scores, lmk, valid, counts = out
        host = (_to_pinned(boxes), _to_pinned(scores), _to_pinned(lmk), _to_pinned(valid),
                {k: _to_pinned(v) for k, v in counts.items()})
        done = torch.cuda.Event()
        done.record()
        return (host, done), n

    def collect(self, handle, return_landmarks=False):
        (out, done), n = handle
        if done is not None:
            done.synchronize()
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


class _BoxDetectorBase:
    """Shared submit / collect for detectors whose forward returns (boxes,
    scores, classes, valid, *counters): YOLO's one counter
    (select_overflow) or Faster R-CNN's three (select_overflow,
    roi_dropped, roi_truncated) (models/wrappers.py:86-153 of the JAX
    package). Subclasses provide ``_name``, ``_counter_warnings`` (one
    "%s ... %d" text per counter, filled with the name and the batch max),
    ``_resized_hw(h, w)`` and ``_forward(x_u8, h, w)``."""

    _counter_warnings = ()

    def _resized_hw(self, h, w):
        raise NotImplementedError

    def _forward(self, x, h, w):
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
        arr, n = pad_batch(frames, self.batch_size or len(frames))
        x = torch.from_numpy(arr)
        cuda = self.device.type == "cuda"
        if cuda:
            x = x.pin_memory().to(self.device, non_blocking=True)
        with config.model_call(), torch.inference_mode():
            out = self._forward(x, h, w)
        if not cuda:
            return (out, None), n
        host = tuple(_to_pinned(t) for t in out)
        done = torch.cuda.Event()
        done.record()
        return (host, done), n

    def collect(self, handle):
        """Wait for a batch; returns per-image (boxes [n, 4], scores [n],
        classes [n]) numpy lists, and warns when a capacity counter is set."""
        (out, done), n = handle
        if done is not None:
            done.synchronize()
        boxes, scores, classes, valid, *counters = (t.numpy() for t in out)
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
    ``"cpu"`` runs on the CPU. ``params``: the JAX package's {"backbone",
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
                 batch_size=None, params=None, host_resize=False, bf16=False, s2d=None):
        from . import yolo as Y

        print("Initializing YOLOv3 model for live-action face detection")
        del s2d
        self.device = config.resolve_device(device)
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
        self.model = model.to(self.device).eval()
        self._geom = {}

    def _resized_hw(self, h, w):
        return self.Y.resized_shape(h, w, self.max_side)

    def _geometry(self, h, w):
        """(resized size, canvas, priors [D, 4], strides [D, 1] on the
        device) of an h x w frame, computed once per frame size."""
        if (h, w) not in self._geom:
            nh, nw = self._resized_hw(h, w)
            canvas = self.Y.canvas_shape(nh, nw)
            priors, strides = self.Y.flat_priors_and_strides(canvas)
            self._geom[(h, w)] = ((nh, nw), canvas, torch.from_numpy(priors).to(self.device),
                                  torch.from_numpy(strides).to(self.device))
        return self._geom[(h, w)]

    def _forward(self, x, h, w):
        resized, canvas, priors, strides = self._geometry(h, w)
        return self.Y.full_forward(self.model, x, resized, canvas, priors, strides,
                                   orig_hw=(h, w) if self.host_resize else None,
                                   compute_dtype=self.compute_dtype)


class FrcnnDetector(_BoxDetectorBase):
    """Anime face detector; reference API parity with AnimeFRCNN
    (rcnn.py:154-177): __call__(list of BGR frames) -> (boxes, scores,
    classes) as per-image numpy lists.

    ``device``: None means the CUDA card and raises when there is none;
    ``"cpu"`` runs the plain RoIAlign on the CPU. ``params``: the JAX
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
                 params=None, resize_spec=(800, 1333), proposal_cap=1000, out_top=100,
                 host_resize=False, bf16=False, roi_method=None):
        from . import rcnn as R

        print("Initializing FasterRCNN model for anime face detection")
        if roi_method not in _ROI_METHODS:
            raise ValueError("unknown roi_method %r (valid: %s)" % (roi_method, _ROI_METHODS))
        self.device = config.resolve_device(device)
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
        self.model = model.to(self.device).eval()
        self._priors = {}

    def _resized_hw(self, h, w):
        return self.R.resized_shape(h, w, *self.resize_spec)

    def _geometry(self, h, w):
        """(resized size, canvas, per-level priors on the device) of an
        h x w frame, computed once per frame size."""
        if (h, w) not in self._priors:
            from ..ops.anchors import get_priors

            nh, nw = self._resized_hw(h, w)
            canvas = self.R.canvas_shape(nh, nw)
            priors = [torch.from_numpy(p).to(self.device) for p in get_priors(
                canvas, self.R.frcnn_bases(), loc="corner", concat=False)]
            self._priors[(h, w)] = ((nh, nw), canvas, priors)
        return self._priors[(h, w)]

    def _forward(self, x, h, w):
        resized, canvas, priors = self._geometry(h, w)
        return self.R.full_forward(self.model, x, resized, canvas, priors,
                                   out_top=self.out_top, proposal_cap=self.proposal_cap,
                                   orig_hw=(h, w) if self.host_resize else None,
                                   compute_dtype=self.compute_dtype)


# the JAX package's RoIAlign formulations; every one runs through K4 here
_ROI_METHODS = (None, "dense", "sorted", "slice", "gather", "pallas", "pallas-interpret")


class _Encoder:
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
    ``device``: None means the CUDA card and raises when there is none."""

    def __init__(self, model, input_size, preprocess, norm_scale, norm_mean,
                 device=None, batch_size=None, device_resize=False, pack_size=256):
        self.device = config.resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = input_size
        self.preprocess = preprocess
        self.norm_scale, self.norm_mean = norm_scale, norm_mean
        self.batch_size = batch_size
        self.device_resize = device_resize
        self.pack_size = pack_size

    def _to_device(self, arr):
        x = torch.from_numpy(arr)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        return x

    def _packed_input(self, images, bs):
        from ..ops import resize_kernel as RK

        packed, sizes = RK.pack_images(images, self.pack_size)
        n = len(images)
        if n < bs:
            packed = np.concatenate([packed, np.repeat(packed[-1:], bs - n, axis=0)])
            sizes = np.concatenate([sizes, np.repeat(sizes[-1:], bs - n, axis=0)])
        return RK.resize_normalize(self._to_device(packed), self._to_device(sizes),
                                   self.input_size, self.norm_scale, self.norm_mean,
                                   swap_rb=True)

    def _host_input(self, images, bs):
        import cv2

        s = self.input_size
        blobs = [cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
                 for img in images]
        arr, _ = pad_batch(blobs, bs)
        u8 = self._to_device(arr)
        # BGR -> RGB, affine normalize, NHWC -> NCHW
        return self.preprocess(u8.flip(-1)).permute(0, 3, 1, 2).contiguous()

    def __call__(self, images):
        images = list(images)
        n = len(images)
        bs = self.batch_size or n
        with config.model_call(), torch.inference_mode():
            x = (self._packed_input if self.device_resize else self._host_input)(images, bs)
            out = self.model(x)
        return out[:n].cpu().numpy()


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
