"""User-facing model wrappers (counterpart of
videotofaces_tpu/models/wrappers.py; this slice has the MTCNN detector).

Weights resolution: converted .npz checkpoints from <repo>/weights, in the
JAX package's layout (see tools/convert_weights.py), turned into the
modules' state dicts by ``utils/weights.mtcnn_from_jax``. When a checkpoint
is absent, the wrapper falls back to seeded random weights (an explicit
``torch.Generator``) with a loud note — every compute path still runs, only
the predictions are untrained.
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
        with torch.inference_mode():
            out = self.M.full_forward(self.model, x, minsize=self.minsize,
                                      caps=self.caps,
                                      compute_dtype=self.compute_dtype)
        if not cuda:
            return (out, None), n

        def to_host(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host

        boxes, scores, lmk, valid, counts = out
        host = (to_host(boxes), to_host(scores), to_host(lmk), to_host(valid),
                {k: to_host(v) for k, v in counts.items()})
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
