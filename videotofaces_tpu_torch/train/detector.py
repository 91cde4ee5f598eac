"""Detector fine-tuning: adapt YOLOv3 to a custom face domain (counterpart
of videotofaces_tpu/train/detector.py). Two paths: head-only re-fit
(``finetune_yolo_head``: the Darknet trunk and the neck held constant, with
no autograd graph through them) and full fine-tuning with layerwise
learning rates (``finetune_yolo_full``: backbone / neck / head at 0.1 /
0.3 / 1.0 x through ``layerwise_tx``, behind global-norm clipping).

Target assignment runs on the host in numpy, copied from the JAX package:
each prior gets an objectness target in {1 positive, 0 negative, -1
ignore} and its matched ground-truth box (max-IoU with the best prior of
each box forced positive), as static-shaped dense targets. The loss is
per-prior BCE objectness with ignore masking, BCE on the class logit of
the positives and GIoU on the decoded boxes (``decode_boxes(mode="yolo")``,
the inference decode), over the candidates in the JAX flat order (level
32 -> 16 -> 8, row-major, anchor-minor; ``models/yolo.py`` flattens the
NCHW maps the same way).

The canvas is NCHW float32 (RGB / 255) here. Each step runs under
``config.model_call()``. No mesh: the sharded steps are not ported yet.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..models import yolo as Y
from ..ops.boxes import decode_boxes
from ..utils.weights import yolo_to_jax
from .optim import AdamW, leaves, refuse_mesh, run_epochs, run_step


# -- host-side target assignment (numpy, as in the JAX package) ---------------


def priors_to_corners(priors):
    """[D, 4] (cx, cy, w, h) -> (x1, y1, x2, y2), numpy."""
    p = np.asarray(priors)
    return np.concatenate([p[:, :2] - p[:, 2:] / 2, p[:, :2] + p[:, 2:] / 2], axis=1)


def iou_matrix(a, b):
    """[N, 4] x [M, 4] corner boxes -> [N, M] IoU, numpy."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def assign_targets(gt_boxes, priors, pos_iou=0.5, neg_iou=0.4):
    """One image: gt corner boxes [G, 4] (canvas coords) -> (obj_t [D]
    float32 in {1, 0, -1}, box_t [D, 4] matched gt corners). IoU >=
    ``pos_iou``: positive; < ``neg_iou``: negative; between: ignored; every
    gt's best-IoU prior is forced positive."""
    d = priors.shape[0]
    obj_t = np.zeros(d, np.float32)
    box_t = np.zeros((d, 4), np.float32)
    gt = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    if gt.shape[0] == 0:
        return obj_t, box_t
    ious = iou_matrix(priors_to_corners(priors), gt)        # [D, G]
    best_gt = ious.argmax(axis=1)
    best_iou = ious[np.arange(d), best_gt]
    obj_t[(best_iou >= neg_iou) & (best_iou < pos_iou)] = -1.0
    obj_t[best_iou >= pos_iou] = 1.0
    forced = ious.argmax(axis=0)                            # [G]
    obj_t[forced] = 1.0
    best_gt[forced] = np.arange(gt.shape[0])
    box_t = gt[best_gt]
    return obj_t, box_t


def assign_batch(gt_boxes_list, priors, pos_iou=0.5, neg_iou=0.4):
    pairs = [assign_targets(g, priors, pos_iou, neg_iou) for g in gt_boxes_list]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def _prepare_yolo_data(frames_u8, gt_boxes_list, priors, pos_iou, neg_iou, nh, nw, ch, cw):
    """cv2 keep-ratio resize onto the /32 canvas (the inference wrapper's
    host_resize path), RGB, ``/ 255.0`` in numpy on the host (not the
    inference preprocess's float32 reciprocal), and per-frame targets.
    Returns (canvas [N, ch, cw, 3] float32 NHWC, obj_t, box_t)."""
    import cv2

    n, h, w = frames_u8.shape[:3]
    sx, sy = nw / w, nh / h
    canvas = np.zeros((n, ch, cw, 3), np.float32)
    obj_ts, box_ts = [], []
    for i in range(n):
        r = cv2.resize(frames_u8[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
        canvas[i, :nh, :nw] = r[..., ::-1].astype(np.float32) / 255.0
        g = np.asarray(gt_boxes_list[i], np.float32).reshape(-1, 4) \
            * np.asarray([sx, sy, sx, sy], np.float32)
        o, bt = assign_targets(g, priors, pos_iou, neg_iou)
        obj_ts.append(o)
        box_ts.append(bt)
    return canvas, np.stack(obj_ts), np.stack(box_ts)


# -- the loss ------------------------------------------------------------------


def giou(pred, gt):
    """Generalized IoU of aligned corner boxes [..., 4] -> [...]."""
    def area(lt, rb):
        wh = torch.clamp(rb - lt, min=0.0)
        return wh[..., 0] * wh[..., 1]

    inter = area(torch.maximum(pred[..., :2], gt[..., :2]),
                 torch.minimum(pred[..., 2:], gt[..., 2:]))
    union = area(pred[..., :2], pred[..., 2:]) + area(gt[..., :2], gt[..., 2:]) - inter
    iou = inter / torch.clamp(union, min=1e-9)
    hull = area(torch.minimum(pred[..., :2], gt[..., :2]),
                torch.maximum(pred[..., 2:], gt[..., 2:]))
    return iou - (hull - union) / torch.clamp(hull, min=1e-9)


def _bce_logits(logit, target):
    return F.binary_cross_entropy_with_logits(logit, target, reduction="none")


def _check_classes(num_classes):
    if num_classes != 1:
        # the loss has no per-gt class targets: only class-0 logits are
        # trained toward 1.0 on positives, so a multi-class head would be
        # silently untrained on classes 1..nc-1
        raise ValueError("detector fine-tuning supports num_classes=1 only "
                         "(face detection); got %d" % num_classes)


def _loss_from_maps(maps, obj_t, box_t, priors, strides, num_classes, box_weight):
    b = maps[0].shape[0]
    flat = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, num_classes + 5) for m in maps],
                     dim=1)                                   # [B, D, 5 + nc]
    # training-only overflow guard: an unconstrained trunk can push the wh
    # regression past exp's float32 range, making inf boxes whose GIoU is NaN
    reg = torch.cat([flat[..., :2], torch.clamp(flat[..., 2:4], -10.0, 10.0)], dim=-1)
    pos = (obj_t > 0.5).to(flat.dtype)
    learn = (obj_t > -0.5).to(flat.dtype)                    # not ignored
    n_pos = torch.clamp(pos.sum(), min=1.0)
    obj_loss = torch.sum(_bce_logits(flat[..., 4], pos) * learn) \
        / torch.clamp(learn.sum(), min=1.0)
    # single face class: the class logit of a positive prior should say "face"
    cls_loss = torch.sum(_bce_logits(flat[..., 5], torch.ones_like(pos)) * pos) / n_pos
    boxes = decode_boxes(reg, priors[None], mode="yolo", strides=strides[None])
    box_loss = torch.sum((1.0 - giou(boxes, box_t)) * pos) / n_pos
    loss = obj_loss + cls_loss + box_weight * box_loss
    return loss, {"obj": obj_loss, "cls": cls_loss, "box": box_loss}


def detection_loss_full(model, images, obj_t, box_t, priors, strides, num_classes=1,
                        box_weight=2.0):
    """One batch through the whole ``YOLOv3``: images [B, 3, Hc, Wc] float
    (the canvas, RGB / 255), targets from ``assign_batch`` and
    ``flat_priors_and_strides`` as tensors. Returns (loss, {"obj", "cls",
    "box"}); differentiable with respect to every leaf that requires grad."""
    _check_classes(num_classes)
    return _loss_from_maps(model(images), obj_t, box_t, priors, strides, num_classes,
                           box_weight)


def detection_loss(model, images, obj_t, box_t, priors, strides, num_classes=1,
                   box_weight=2.0):
    """Head-only view of ``detection_loss_full``: the backbone and the neck
    run without autograd (constants), only ``model.head`` is differentiated."""
    _check_classes(num_classes)
    with torch.no_grad():
        feats = model.neck(*model.backbone(images))
    return _loss_from_maps(model.head(*feats), obj_t, box_t, priors, strides, num_classes,
                           box_weight)


def _step(loss_fn, model, opt, images, obj_t, box_t, priors, strides, num_classes,
          box_weight):
    loss, aux = run_step(opt, lambda: loss_fn(model, images, obj_t, box_t, priors, strides,
                                              num_classes, box_weight))
    return loss, {k: v.detach() for k, v in aux.items()}


def train_step(model, opt, images, obj_t, box_t, priors, strides, num_classes=1,
               box_weight=2.0):
    """One head-only step (``detection_loss``) with ``opt`` over the head's
    leaves (``bn_stats_frozen``). Returns (loss, aux)."""
    return _step(detection_loss, model, opt, images, obj_t, box_t, priors, strides,
                 num_classes, box_weight)


def train_step_full(model, opt, images, obj_t, box_t, priors, strides, num_classes=1,
                    box_weight=2.0):
    """One full step (``detection_loss_full``) with ``opt`` from
    ``layerwise_tx``. Returns (loss, aux); ``opt.grad_norm`` holds the
    global norm the clip saw."""
    return _step(detection_loss_full, model, opt, images, obj_t, box_t, priors, strides,
                 num_classes, box_weight)


def _is_bn_stat(name):
    """BatchNorm statistics: leaves, not weights to train (AdamW would drive
    var negative and NaN the forward on sqrt(var + eps))."""
    parts = name.split(".")
    return "bn" in parts and parts[-1] in ("running_mean", "running_var")


def bn_stats_frozen(named_leaves, learning_rate, weight_decay=1e-4):
    """AdamW over ``named_leaves`` with every ``bn`` statistic frozen
    (``optax.multi_transform`` with ``set_to_zero``); BatchNorm scale and
    bias train."""
    return AdamW(named_leaves, learning_rate, weight_decay,
                 scale_of=lambda name: 0.0 if _is_bn_stat(name) else 1.0)


def layerwise_tx(model, learning_rate, scales=None, clip_norm=1.0):
    """Discriminative layerwise AdamW over every leaf of ``model``:
    ``scales`` maps the top-level modules ('backbone', 'neck', 'head') to
    learning-rate multipliers, merged over the defaults 0.1 / 0.3 / 1.0
    (0.0 freezes a module), BatchNorm statistics frozen, behind global-norm
    clipping at ``clip_norm`` (None: none) over every leaf's gradient."""
    scales = {**{"backbone": 0.1, "neck": 0.3, "head": 1.0}, **(scales or {})}

    def scale_of(name):
        return 0.0 if _is_bn_stat(name) else scales[name.split(".")[0]]

    return AdamW(leaves(model), learning_rate, scale_of=scale_of, clip_norm=clip_norm)


def _setup(frames_u8, gt_boxes_list, max_side, num_classes, params, pos_iou, neg_iou,
           device):
    """The model on the device, the host data and the priors of both loops."""
    from ..models.wrappers import _resolve_checkpoint

    frames_u8 = np.asarray(frames_u8)
    h, w = frames_u8.shape[1:3]
    nh, nw = Y.resized_shape(h, w, max_side)
    ch, cw = Y.canvas_shape(nh, nw)
    priors, strides = Y.flat_priors_and_strides((ch, cw))
    if params is None:
        params = _resolve_checkpoint("yolov3_wider")
    model = (Y.YOLOv3.seeded(0, num_classes) if params is None
             else Y.YOLOv3.from_jax(params, num_classes)).to(device)
    data = _prepare_yolo_data(frames_u8, gt_boxes_list, priors, pos_iou, neg_iou,
                              nh, nw, ch, cw)
    return model, data, torch.from_numpy(priors).to(device), \
        torch.from_numpy(strides).to(device)


def _fit(step, model, opt, data, pr, st, epochs, batch_size, seed, num_classes,
         box_weight, device):
    canvas, obj_ts, box_ts = data

    def run_batch(idx):
        x = torch.from_numpy(canvas[idx]).to(device).permute(0, 3, 1, 2).contiguous()
        return step(model, opt, x, torch.from_numpy(obj_ts[idx]).to(device),
                    torch.from_numpy(box_ts[idx]).to(device), pr, st, num_classes,
                    box_weight)[0]

    return run_epochs(len(canvas), epochs, batch_size, seed, run_batch)


def finetune_yolo_head(frames_u8, gt_boxes_list, epochs=5, batch_size=8, learning_rate=1e-4,
                       max_side=608, num_classes=1, mesh=None, seed=0, params=None,
                       pos_iou=0.5, neg_iou=0.4, box_weight=2.0, *, device=None):
    """Head-only fine-tune: uint8 BGR frames [N, H, W, 3] + per-frame gt
    corner boxes (original pixel coordinates) -> (the whole tree in the JAX
    layout, numpy arrays, trunk untouched; history of per-epoch mean
    losses). ``params``: a JAX-layout tree (None: the converted checkpoint,
    or seeded weights with a note). The tree loads into
    ``YoloDetector(params=)``. ``mesh``: the JAX loop's data mesh;
    anything but None raises (``optim.refuse_mesh``). ``device``: None
    means the card."""
    refuse_mesh(mesh)
    device = config.resolve_device(device)
    model, data, pr, st = _setup(frames_u8, gt_boxes_list, max_side, num_classes, params,
                                 pos_iou, neg_iou, device)
    # the head's bridges are ConvUnits with statistics: frozen here too
    opt = bn_stats_frozen(leaves(model.head), learning_rate)
    history = _fit(train_step, model, opt, data, pr, st, epochs, batch_size, seed,
                   num_classes, box_weight, device)
    return yolo_to_jax(model.state_dict()), history


def finetune_yolo_full(frames_u8, gt_boxes_list, epochs=5, batch_size=8, learning_rate=1e-4,
                       trunk_scales=None, max_side=608, num_classes=1, mesh=None, seed=0,
                       params=None, pos_iou=0.5, neg_iou=0.4, box_weight=2.0, *,
                       device=None):
    """Full fine-tune with layerwise learning rates (``trunk_scales`` ->
    ``layerwise_tx``). Same data path and return contract as
    ``finetune_yolo_head``."""
    refuse_mesh(mesh)
    device = config.resolve_device(device)
    model, data, pr, st = _setup(frames_u8, gt_boxes_list, max_side, num_classes, params,
                                 pos_iou, neg_iou, device)
    opt = layerwise_tx(model, learning_rate, trunk_scales)
    history = _fit(train_step_full, model, opt, data, pr, st, epochs, batch_size, seed,
                   num_classes, box_weight, device)
    return yolo_to_jax(model.state_dict()), history
