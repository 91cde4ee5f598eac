"""Frozen copy of the port's ops/nms.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import torch

from .boxes import box_iou_matrix


def _sort_desc(x, dim=-1):
    return torch.sort(x, dim=dim, descending=True, stable=True)


def _masked(scores, valid):
    return torch.where(valid, scores, torch.full_like(scores, float("-inf")))


def _fixpoint_presorted(boxes, valid, iou_thr, plus_one=False, mode="iou",
                        group_ids=None):
    """Greedy keep mask for [B, K, 4] boxes ALREADY in descending score
    order; returns [B, K] bool in that order. With ``group_ids`` [B, K],
    only boxes of the same group suppress each other."""
    k = boxes.shape[-2]
    iou = box_iou_matrix(boxes, boxes, plus_one=plus_one, mode=mode)
    later = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    suppresses = (iou > iou_thr) & later          # [.., j, i]: j (if kept) kills i
    if group_ids is not None:
        suppresses = suppresses & (group_ids[..., :, None] == group_ids[..., None, :])
    keep = valid
    for _ in range(k):
        killed = torch.any(suppresses & keep[..., :, None], dim=-2)
        new = valid & ~killed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_keep_mask(boxes, scores, valid, iou_thr, group_ids=None, plus_one=False,
                  mode="iou", presorted=False):
    """Greedy NMS over a padded buffer: boxes [..., K, 4], scores [..., K],
    valid [..., K] bool, group_ids [..., K] int or None. Suppression happens
    only within a group (torchvision ``batched_nms`` semantics, the same as
    independent per-group NMS). Returns the keep mask in input order."""
    if presorted:
        return _fixpoint_presorted(boxes, valid, iou_thr, plus_one, mode, group_ids)
    _, order = _sort_desc(_masked(scores, valid))
    sb = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    sv = torch.gather(valid, -1, order)
    sg = None if group_ids is None else torch.gather(
        group_ids.expand(valid.shape), -1, order)
    keep_sorted = _fixpoint_presorted(sb, sv, iou_thr, plus_one, mode, sg)
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def nms_keep_mask_bucketed(boxes, scores, valid, iou_thr, bucket=256,
                           plus_one=False, mode="iou"):
    """Batched ``nms_keep_mask`` ([B, K] buffers) that runs a [bucket, bucket]
    problem whenever every row's valid count fits — exact either way: after
    the stable sort, slots beyond the valid count are invalid and can be
    neither kept nor suppress anything."""
    k = scores.shape[1]
    if k <= bucket:
        return nms_keep_mask(boxes, scores, valid, iou_thr, None, plus_one, mode)
    _, order = _sort_desc(_masked(scores, valid), dim=1)
    sb = torch.gather(boxes, 1, order[..., None].expand(boxes.shape))
    sv = torch.gather(valid, 1, order)
    if int(valid.sum(dim=1).max()) <= bucket:
        small = _fixpoint_presorted(sb[:, :bucket], sv[:, :bucket], iou_thr,
                                    plus_one, mode)
        keep_sorted = torch.nn.functional.pad(small, (0, k - bucket))
    else:
        keep_sorted = _fixpoint_presorted(sb, sv, iou_thr, plus_one, mode)
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def iom_chain_suppress(boxes, scores, valid, iom_thr, group_ids=None, plus_one=True):
    """MTCNN final-stage 'Min' NMS with chain suppression, batched over the
    leading dims: a candidate is dropped iff ANY candidate earlier in stable
    descending score order (within its group, when ``group_ids`` [..., K]
    is given) has intersection-over-minimum above the threshold, whether or
    not that one survives (detectors/mtcnn.py:273-309, method='Min')."""
    k = boxes.shape[-2]
    _, order = _sort_desc(_masked(scores, valid))
    ar = torch.arange(k, dtype=torch.int64, device=boxes.device).expand(order.shape)
    rank = torch.zeros_like(order).scatter(-1, order, ar)
    iom = box_iou_matrix(boxes, boxes, plus_one=plus_one, mode="iom")
    earlier = rank[..., :, None] < rank[..., None, :]   # [j, i]: j earlier than i
    kills = (iom > iom_thr) & earlier & valid[..., :, None]
    if group_ids is not None:
        kills &= group_ids[..., :, None] == group_ids[..., None, :]
    return valid & ~torch.any(kills, dim=-2)


def take_rows(a, idx):
    """Gather rows ``idx`` [B, k] along axis 1 of a [B, K, ...] tensor."""
    return torch.gather(a, 1, idx.reshape(idx.shape + (1,) * (a.dim() - 2))
                        .expand(idx.shape + a.shape[2:]))


def topk_by_score(scores, keep, topk):
    """Indices of the top-k kept candidates by score along the last axis,
    padded with validity: (idx [..., topk], valid [..., topk]). Descending
    score order, lower index first among ties (``lax.top_k``'s order)."""
    vals, idx = _sort_desc(_masked(scores, keep))
    vals, idx = vals[..., :topk], idx[..., :topk]
    return idx, vals > float("-inf")
