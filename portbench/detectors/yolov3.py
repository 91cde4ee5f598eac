"""YOLOv3 (``live_yolov3_facenet``): the program's ``YoloDetector`` and the
plain ``reference/yolo.py``. No hand-written kernel: Darknet-53, the neck
and the head are cuDNN convolutions, the selection a sort and the NMS a
fixpoint of plain tensor operations."""

import math

import numpy as np
import torch

from portbench import flops, models

# the size at which the harness's CPU tests run it (``tests/tiny.py``): a
# 96 x 160 canvas on 192 x 112 clips
TINY = {"max_side": 160}

# the postprocess's thresholds and capacities, as the configuration states them
POST = ("conf_thr", "score_thr", "iou_thr", "pre_topk", "out_topk")


def _post(cfg):
    return {k: cfg["detector"][k] for k in POST}


def _logit(p):
    return math.log(p / (1.0 - p))


def reference(cfg):
    from portbench.reference.yolo import YOLOv3

    return YOLOv3(cfg["detector"].get("num_classes", 1))


def program(cfg, device):
    from videotofaces_tpu_torch.models import wrappers as W

    return W.YoloDetector(device, max_side=cfg["detector"]["max_side"])


def kernel_inputs(cfg):
    return []


def detect(cfg, model, frames, batch):
    from portbench.reference import yolo as Y

    out = []
    for x, n in models.blocks(model, frames, batch):
        with torch.no_grad():
            boxes, scores, _, valid, _ = Y.full_forward(
                model, x, cfg["detector"]["max_side"], **_post(cfg))
        out += models.valid_rows(boxes, scores, valid, n)
    return out


def _interior(stride, hw, resized):
    """[h, w] bool: the locations of a level whose prior centre lies at
    least one stride inside the resized image (not in the canvas's pad)."""
    cy = (torch.arange(hw[0]) + 0.5) * stride
    cx = (torch.arange(hw[1]) + 0.5) * stride
    return (((cy > stride) & (cy < resized[0] - stride))[:, None]
            & ((cx > stride) & (cx < resized[1] - stride))[None, :])


def _quiet_border(w, inner, border, ratio, ridge=1e-2):
    """The row ``w`` [C] without its components along the directions of
    the features in which the border locations ``border`` [N, C] vary
    more than ``ratio`` times as much as the interior ones ``inner``
    (about the interior mean): the generalized eigenvectors V of the two
    second moments, V' M V = I and V' S_border V = diag(mu), M the interior
    covariance with a ridge of ``ridge`` x its mean eigenvalue; w = V a, and
    a_j is zeroed where mu_j > ratio. Returns the row and the count of
    directions dropped."""
    c = inner.shape[1]
    mean = inner.mean(0)
    m = torch.cov(inner.T)
    m += ridge * torch.trace(m) / c * torch.eye(c, dtype=m.dtype, device=m.device)
    dev = border - mean
    sb = dev.T @ dev / len(border)
    ev, u = torch.linalg.eigh(m)
    half = u @ torch.diag(ev.rsqrt()) @ u.T
    mu, q = torch.linalg.eigh(half @ sb @ half)
    v = half @ q
    coef = v.T @ m @ w
    drop = mu > ratio
    coef[drop] = 0.0
    return v @ coef, int(drop.sum())


@torch.no_grad()
def calibrate(cfg, ref, frames):
    """Rewrites the prediction rows of ``head.pred0..2`` so that the seeded
    detector finds about ``per_frame`` candidates a frame, ``kept_per_frame``
    of its detections passing the box rules, on any seed. Random weights
    put each objectness row's logits at a level and spread that vary from
    seed to seed and row to row by more than the whole range between no
    candidate and every location one, and they answer most strongly at
    the frame's edges and the canvas's pad, where every box fails the
    border rule; their box rows make most boxes tens of times their anchor.
    On ``frames``, by the reference:

    - each box row (t_xy, t_wh) is scaled by ``box_scale``, the seeding's
      factor for regression heads, which YOLO's one prediction convolution
      of box, objectness and class rows does not get there;
    - each class row becomes weight 0 and bias logit(``class_score``): every
      location's class score is that constant, above ``score_thr``, so the
      candidates, their order and the NMS follow the objectness alone;
    - each of the 9 objectness rows (3 levels x 3 anchors) loses its
      components along the directions of the bridge's features in which
      the border locations (prior centre within a stride of the resized
      image's edge, or in the pad) vary more than ``border_ratio`` times
      as much as the interior ones (``_quiet_border``);
    - and is mapped by o -> gain x (o - cut) / span + logit(``conf_thr``):
      the row's cut midway between its k-th and (k+1)-th largest logit over
      the frames, k its share by locations of ``per_frame`` x the frames,
      and span its largest logit less the cut. About ``per_frame``
      candidates a frame enter NMS, from every row in proportion to its
      locations, and none of the calibration frames' candidates sits on a
      cut; their margins (o - cut) / span lie in (0, 1], so that no score
      reaches float32's 1 at the gains needed. The NMS and its top
      ``out_topk`` do not depend on the gain (it keeps the order), so the
      gain is read off the detections at gain 1: the one that puts the
      score cut ``threshold`` midway between the k2-th and (k2 + 1)-th
      largest margin of the detections whose boxes pass the size and
      border rules (``criteria``), k2 = ``kept_per_frame`` x the frames.

    Objectness biases are replaced. Returns, under ``head.pred``, each
    row's cut, the gain, the logits read, the directions dropped per row
    and, on the calibrated reference, per frame: the candidates, the
    detections at ``threshold``, those passing the box rules and those
    whose score is ``class_score`` itself (objectness 1 in float32)."""
    from portbench.reference import pipeline as RP
    from portbench.reference import yolo as Y

    d = cfg["detector"]
    (spec,) = d["calibrate"]
    crit = spec["criteria"]
    nc = ref.num_classes
    per = nc + 5
    dev = next(ref.parameters()).device
    h, w = frames[0].shape[:2]
    resized, canvas, priors, strides = Y.geometry(h, w, d["max_side"], dev)
    preds = [ref.get_submodule("head.pred%d" % i) for i in range(3)]
    for pred in preds:
        for a in range(3):
            pred.weight[a * per:a * per + 4] *= spec["box_scale"]
            pred.bias[a * per:a * per + 4] *= spec["box_scale"]

    feats = [[] for _ in preds]
    hooks = [pred.register_forward_pre_hook(lambda mod, args, f=f: f.append(args[0]))
             for pred, f in zip(preds, feats)]
    try:
        blocks = [[m[:n] for m in ref(Y.preprocess(x, resized, canvas))]
                  for x, n in models.blocks(ref, frames, 4)]
    finally:
        for hk in hooks:
            hk.remove()
    sizes = [len(m[0]) for m in blocks]
    maps = [torch.cat(level).double() for level in zip(*blocks)]   # [frames, 3 * per, h, w]
    n_loc = sum(m[0, 0].numel() * 3 for m in maps)
    rows, dropped = {}, []
    for i, (stride, f) in enumerate(zip((32, 16, 8), feats)):
        x = torch.cat([b[:n] for b, n in zip(f, sizes)]).double().permute(0, 2, 3, 1)
        inner = _interior(stride, x.shape[1:3], resized).to(dev)
        c = x.shape[-1]
        xi, xb = x[:, inner].reshape(-1, c), x[:, ~inner].reshape(-1, c)
        k = max(1, round(spec["per_frame"] * len(frames) * inner.numel() / n_loc))
        for a in range(3):
            r = a * per + 4
            row, n_drop = _quiet_border(preds[i].weight[r, :, 0, 0].double(), xi,
                                        xb, spec["border_ratio"])
            o = x @ row
            top = torch.topk(o.flatten(), k + 1).values
            cut = float((top[-2] + top[-1]) / 2)
            span = float(top[0]) - cut
            rows[i, r] = row, cut, span
            maps[i][:, r] = (o - cut) / span
            dropped.append(n_drop)
    flat = Y.flat_maps(maps, nc)
    z = flat[..., 4]
    conf, cls_logit = _logit(d["conf_thr"]), _logit(spec["class_score"])

    # the detections at gain 1; their margins z come back from the scores,
    # sigmoid(z + conf) x class_score
    flat[..., 4] = z + conf
    flat[..., 5:] = cls_logit
    flat = flat.float()
    sy, sx = h / resized[0], w / resized[1]
    margins = []
    for s in range(0, len(frames), 4):
        boxes, scores, _, valid, _ = Y.detect_flat(flat[s:s + 4], priors, strides, **_post(cfg))
        boxes = boxes * torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=dev)
        for b, sc, v in zip(boxes.cpu().numpy(), scores.cpu().numpy(), valid.cpu().numpy()):
            b, sc = b[v], sc[v].astype(np.float64)
            ok = RP.passes(RP.round_out(b), np.ones(len(sc)), (h, w), 0.0, crit["min_size"],
                           crit["min_border"])
            q = np.clip(sc[ok] / spec["class_score"], 1e-12, 1.0 - 1e-7)
            margins += list(np.log(q / (1.0 - q)) - conf)
    if not margins:
        raise RuntimeError("calibrating head.pred: no detection passes the size and border "
                           "rules on the calibration frames")
    margins = np.sort(np.asarray(margins))[::-1]
    k2 = round(spec["kept_per_frame"] * len(frames))
    mid = (margins[k2 - 1] + margins[k2]) / 2 if len(margins) > k2 else margins[-1] / 2
    gain = (_logit(spec["threshold"] / spec["class_score"]) - conf) / mid

    for (i, r), (row, cut, span) in rows.items():
        pred = preds[i]
        pred.weight[r, :, 0, 0] = (gain / span * row).to(pred.weight.dtype)
        pred.bias[r] = gain * (-cut / span) + conf
        pred.weight[r + 1:r + 1 + nc] = 0.0
        pred.bias[r + 1:r + 1 + nc] = cls_logit

    n_cand, n_det, n_kept, n_top = [], [], [], []
    for x, n in models.blocks(ref, frames, 4):
        boxes, scores, _, valid, cand = Y.full_forward(ref, x, d["max_side"], **_post(cfg))
        n_cand += cand[:n].tolist()
        for b, sc in models.valid_rows(boxes, scores, valid, n):
            n_det.append(int((sc >= spec["threshold"]).sum()))
            n_top.append(int((sc >= np.float32(spec["class_score"])).sum()))
            n_kept.append(int(RP.passes(RP.round_out(b), sc, (h, w), spec["threshold"],
                                        crit["min_size"], crit["min_border"]).sum()))
    return {"head.pred": {"cuts": [rows[key][1] for key in sorted(rows)], "gain": gain,
                          "logits": z.numel(),
                          "dropped": dropped,
                          "candidates_per_frame": float(np.mean(n_cand)),
                          "candidates_max": int(max(n_cand)),
                          "detections_per_frame": float(np.mean(n_det)),
                          "kept_per_frame": float(np.mean(n_kept)),
                          "saturated_per_frame": float(np.mean(n_top))}}


def work(run, ref, frame):
    """The detector's FLOPs per frame (one forward of ``frame`` through the
    reference: Darknet-53, the neck and the head at the canvas) times the
    window's frames."""
    per_frame = flops.forward_ops(ref, lambda: detect(run.config, ref, [frame[0].cpu().numpy()], 1))
    run.work["model_flops"] = per_frame * run.counts["frames"]
