"""A configuration's models, on both sides: the program's wrappers (the
system under test) and the plain reference modules, given one state made
from the seed (``seeding.py``), and the reference's forward passes at the
sizes the program runs."""

import contextlib

import numpy as np
import torch

from . import registry, seeding


def detector(cfg):
    """The module of the configuration's detector, ``detectors/<model>.py``
    (``registry.detector``)."""
    return registry.detector(cfg["detector"]["model"])


def reference_detector(cfg):
    return detector(cfg).reference(cfg)


def reference_encoder(cfg):
    e = cfg["encoder"]
    if e["model"] == "facenet":
        from .reference.facenet import InceptionResnetV1

        return InceptionResnetV1()
    if e["model"] == "vit":
        from .reference.vit import ViT

        return ViT(**e["arch"])
    raise ValueError("no reference for encoder %r" % e["model"])


def detector_state(cfg, seed, device, frames):
    """The detector's state from ``seed``, calibrated on ``frames`` by its
    module (``calibrate_heads`` for the R-CNN and MTCNN), on the host; and
    the calibration's values per layer."""
    ref = reference_detector(cfg).to(device).eval()
    seeding.seed_module_(ref, seed)
    calibration = detector(cfg).calibrate(cfg, ref, frames)
    return seeding.host_state(ref), calibration


@torch.no_grad()
def calibrate_heads(cfg, ref, frames):
    """Random weights put the face-minus-other logit margin of a detector
    head at a level and spread that vary from seed to seed by more than
    the whole range between no face and every candidate a face. So, layer
    by layer in cascade order, the reference runs on ``frames``, the
    layer's margin d = logit[face] - logit[other] is read over its live
    inputs (a slot whose input crop is all zero is dead), and the face row
    is rewritten so that the margin becomes (d - d_k) / std(d) +
    logit(threshold), d_k midway between the k-th and the (k+1)-th largest
    margin, k = ``per_frame`` x the frames: about ``per_frame`` candidates
    of a frame pass the layer's threshold, whatever the seed, and none of
    the calibration frames' candidates sits on it. Returns per layer the
    margin cut d_k, the gain 1 / std(d), the live margins read and, where
    the spec keeps ``kept_per_frame``, the further shift of the face logit
    (``_kept_shift``)."""
    import math

    out = {}
    for spec in cfg["detector"].get("calibrate", []):
        layer = ref.get_submodule(spec["layer"])
        owner = ref.get_submodule(spec["owner"])
        face = spec["face"]
        live, margins = [], []

        def owner_in(mod, args):
            x = args[0]
            live.append(x.flatten(1).abs().sum(1) > 0 if spec["per_slot"] else None)

        def layer_out(mod, args, out):
            d = (out[:, face] - out[:, 1 - face]).double()
            keep = live[-1]
            margins.append(d.flatten() if keep is None else d[keep].flatten())

        hooks = [owner.register_forward_pre_hook(owner_in),
                 layer.register_forward_hook(layer_out)]
        try:
            reference_detect(cfg, ref, frames)
        finally:
            for hk in hooks:
                hk.remove()
        d = torch.cat(margins)
        if d.numel() < 2:
            raise RuntimeError("calibrating %s: %d live input(s) on the calibration frames"
                               % (spec["layer"], d.numel()))
        k = min(d.numel() - 1, max(1, round(spec["per_frame"] * len(frames))))
        top = torch.topk(d, k + 1).values
        d_k = (top[-2] + top[-1]) / 2     # midway: no calibration candidate on the edge
        gain = 1.0 / d.std().clamp(min=1e-12)
        t = spec["threshold"]
        target = math.log(t / (1.0 - t))
        w, b = layer.weight, layer.bias
        other = 1 - face
        w[face] = (w[other] + (w[face] - w[other]) * gain).to(w.dtype)
        b[face] = (b[other] + (b[face] - b[other] - d_k) * gain + target).to(b.dtype)
        out[spec["layer"]] = {"d_k": float(d_k), "gain": float(gain), "margins": d.numel()}
        if "kept_per_frame" in spec:
            shift = _kept_shift(cfg, ref, frames, spec, face, target)
            b[face] += shift
            out[spec["layer"]]["kept_shift"] = shift
    return out


def _kept_shift(cfg, ref, frames, spec, face, target, lift=4.0):
    """The shift of the face margin after which ``kept_per_frame`` of the
    detector's final detections per frame pass the box rules
    (``spec["criteria"]``: score, size and border): the detections at the
    margin lifted by ``lift`` (a uniform shift keeps the NMS order, so the
    final detections at any lower margin are those of them that still
    score above the cut), their margins recovered from the scores, and the
    cut put midway between the k-th and (k+1)-th margin of those whose
    boxes pass the size and border rules."""
    b = ref.get_submodule(spec["layer"]).bias
    b[face] += lift
    try:
        dets = reference_detect(cfg, ref, frames)
    finally:
        b[face] -= lift
    from .reference import pipeline as RP

    crit = spec["criteria"]
    margins = []
    for frame, (boxes, scores) in zip(frames, dets):
        ok = RP.passes(RP.round_out(boxes), np.ones(len(scores)), frame.shape[:2], 0.0,
                       crit["min_size"], crit["min_border"])
        sc = np.clip(scores[ok].astype(np.float64), 1e-12, 1 - 1e-12)
        margins += list(np.log(sc / (1 - sc)) - lift)
    margins = np.sort(np.asarray(margins))[::-1]
    k = round(spec["kept_per_frame"] * len(frames))
    if not len(margins):
        return 0.0
    if len(margins) <= k:     # fewer pass the size and border rules: keep them all
        return float(target - (margins[-1] - 1.0))
    return float(target - (margins[k - 1] + margins[k]) / 2)


def encoder_state(cfg, seed, device, calib_images=None):
    """The encoder's state from ``seed`` (the detector's stream is
    ``seed``, the encoder's ``seed + 1``), then the configuration's
    calibration on ``calib_images`` (uint8 BGR squares at the input size):
    ``head_whiten`` folds a ZCA whitening of FaceNet's head features (their
    covariance over the images, eigenvalues floored at ``whiten_floor`` x
    the largest) into the head and its BatchNorm, ``center_norm`` moves
    the ViT's last LayerNorm bias by minus its mean output; a random
    network otherwise embeds every crop in nearly one direction, and the
    embedding dedup would keep a handful of faces."""
    e = cfg["encoder"]
    ref = reference_encoder(cfg).to(device).eval()
    seeding.seed_module_(ref, seed + 1)
    how = e.get("calibrate")
    if how:
        x = encoder_input(cfg, np.stack(calib_images), device)
        with torch.no_grad():
            if how == "head_whiten":
                feats = []
                hook = ref.head.register_forward_hook(lambda m, i, o: feats.append(o))
                for blk in x.split(64):
                    ref(blk)
                hook.remove()
                f = torch.cat(feats).double()
                mu = f.mean(0)
                cov = torch.cov(f.T)
                evals, evecs = torch.linalg.eigh(cov)
                floor = e["whiten_floor"] * evals.clamp(min=0).max()
                zca = evecs @ torch.diag((evals.clamp(min=0) + floor).rsqrt()) @ evecs.T
                ref.head.weight.copy_((zca @ ref.head.weight.double()).float())
                ref.head_bn.running_mean.copy_((zca @ mu).float())
                ref.head_bn.running_var.fill_(1.0)
            elif how == "center_norm":
                ref.norm.bias.sub_(ref(x).double().mean(0).float())
            else:
                raise ValueError("unknown calibration %r" % how)
    return seeding.host_state(ref)


def encoder_input(cfg, crops_u8, device):
    """Square uint8 BGR crops [N, S, S, 3] at the input size -> the
    normalized RGB NCHW batch: (x - mean) * scale."""
    e = cfg["encoder"]
    x = torch.from_numpy(np.ascontiguousarray(crops_u8)).to(device).flip(-1).float()
    x = (x - e["norm_mean"]) * e["norm_scale"]
    return x.permute(0, 3, 1, 2).contiguous()


def program_detector(cfg, state, device):
    """The program's detector wrapper on ``device``, holding ``state``."""
    det = detector(cfg).program(cfg, device)
    seeding.load_state_(det.model, state)
    return det


def program_encoder(cfg, state, device):
    from videotofaces_tpu_torch.models import wrappers as W

    e = cfg["encoder"]
    if e["model"] == "facenet":
        enc = W.FaceNetEncoder(device)
    elif e["model"] == "vit":
        enc = W.VitEncoder(device, large=e["arch"]["dim"] > 768)
    else:
        raise ValueError("unknown encoder %r" % e["model"])
    seeding.load_state_(enc.model, state)
    return enc


# -- the reference's forward passes ------------------------------------------------


@contextlib.contextmanager
def kernel_inputs(cfg):
    """While open, the reference's stand-ins for the program's hand-written
    kernels that the configuration's detector launches keep, per call,
    the inputs that the kernel's work depends on (host copies; the
    detector's module names its stand-ins and what each keeps). Yields the
    list of calls."""
    calls = []
    patched = []
    try:
        for module, name, keep in detector(cfg).kernel_inputs(cfg):
            fn = getattr(module, name)

            def recording(*args, fn=fn, keep=keep):
                calls.append(keep(*args))
                return fn(*args)

            setattr(module, name, recording)
            patched.append((module, name, fn))
        yield calls
    finally:
        for module, name, fn in reversed(patched):
            setattr(module, name, fn)


def reference_detect(cfg, model, frames, batch=4):
    """Per frame (boxes [n, 4], scores [n]) numpy, frames in blocks of
    ``batch`` (BGR uint8, one size; a short last block padded with its
    last frame, as the program pads its batches), in float32 on the
    model's device."""
    return detector(cfg).detect(cfg, model, frames, batch)


def blocks(model, frames, batch):
    """(x, n) per block of ``batch`` frames: uint8 [batch, h, w, 3] on the
    model's device, a short last block padded with its last frame; n the
    block's own frames."""
    dev = next(model.parameters()).device
    for s in range(0, len(frames), batch):
        block = list(frames[s:s + batch])
        n = len(block)
        block += block[-1:] * (batch - n)
        yield torch.from_numpy(np.stack(block)).to(dev), n


def valid_rows(boxes, scores, valid, n):
    """The first ``n`` images' (boxes, scores) of a block's outputs, their
    valid rows, numpy."""
    boxes, scores, valid = boxes.cpu().numpy(), scores.cpu().numpy(), valid.cpu().numpy()
    return [(boxes[i][valid[i]], scores[i][valid[i]]) for i in range(n)]


def reference_embed(cfg, model, crops, batch=64):
    """[N, D] float32 embeddings of BGR crops of any size: cv2 bilinear
    resize to the input size, normalize, forward in blocks."""
    import cv2

    s = cfg["encoder"]["input_size"]
    dev = next(model.parameters()).device
    out = []
    for k in range(0, len(crops), batch):
        sq = np.stack([cv2.resize(c, (s, s), interpolation=cv2.INTER_LINEAR)
                       for c in crops[k:k + batch]])
        with torch.no_grad():
            out.append(model(encoder_input(cfg, sq, dev)).float().cpu().numpy())
    return np.concatenate(out)
