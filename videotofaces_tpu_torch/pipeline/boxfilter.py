"""Box filtering, expansion and squaring (host-side, vectorized numpy).

Behavioral contract (reference detection.py:165-262):

- raw detector boxes are rounded outward to ints (floor x1/y1, ceil x2/y2);
- a box is rejected if score < min_score (c1), width or height < min_size
  (c2), or any edge closer than min_border to the frame border (c3);
- survivors are scaled about their center by 4 factors (left, right, up,
  down), clamped to the frame with outward rounding;
- optional squaring grows the short side symmetrically, shifts back in-bounds,
  and finally shrinks if the grown side exceeds the frame's other dimension.

Audit outputs preserved: annotated debug frames (green/red boxes + scores,
JPEG q50, <=1024px), reject crops, and the append-mode
``intermediate/log_rejects.csv`` with per-condition columns.
"""

import os.path as osp

import cv2
import numpy as np


def round_out(boxes):
    """[N, >=4] float -> int array [N, 4]: floor mins, ceil maxes."""
    out = np.empty((len(boxes), 4), dtype=np.int64)
    if len(boxes):
        b = np.asarray(boxes, dtype=np.float64)
        b = np.where(np.isfinite(b), b, 0.0)  # guard: untrained weights can emit inf/nan
        out[:, 0] = np.floor(b[:, 0])
        out[:, 1] = np.floor(b[:, 1])
        out[:, 2] = np.ceil(b[:, 2])
        out[:, 3] = np.ceil(b[:, 3])
    return out


def check_conditions(iboxes, scores, img_size, min_score, min_size, min_border):
    """Three rejection conditions as bool arrays [N] (c1=score, c2=size, c3=border)."""
    h, w = img_size
    n = len(iboxes)
    if n == 0:
        z = np.zeros(0, dtype=bool)
        return z, z, z
    c1 = scores < min_score
    c2 = (iboxes[:, 2] - iboxes[:, 0] < min_size) | (iboxes[:, 3] - iboxes[:, 1] < min_size)
    if min_border:
        c3 = ((iboxes[:, 0] < min_border) | (iboxes[:, 1] < min_border)
              | (iboxes[:, 2] > w - min_border) | (iboxes[:, 3] > h - min_border))
    else:
        c3 = np.zeros(n, dtype=bool)
    return c1, c2, c3


def render_debug_frame(frame, iboxes, scores, rejected, out_path):
    """Annotated frame: green passed / red rejected boxes + scores, <=1024px, q50."""
    h, w = frame.shape[:2]
    scale = 1024 / max(h, w)
    fm = cv2.resize(frame, (int(w * scale), int(h * scale)))
    for k in range(len(iboxes)):
        x1, y1, x2, y2 = (iboxes[k] * scale).astype(int)
        color = (0, 0, 255) if rejected[k] else (0, 255, 0)
        cv2.rectangle(fm, (x1, y1), (x2, y2), color, 2)
        ty = y1 - 2 if y1 > 10 else y2 - 2
        cv2.putText(fm, str(round(float(scores[k]), 2)), (x1, ty), 0, 0.6, color, 1,
                    lineType=cv2.LINE_AA)
    cv2.imwrite(out_path, fm, [int(cv2.IMWRITE_JPEG_QUALITY), 50])


def save_rejects_and_log(frame, frame_index, iboxes, scores, c1, c2, c3,
                         out_dir, out_prefix, min_score, min_size, min_border):
    """Reject crops to intermediate/rejects + append-mode log_rejects.csv."""
    h, w = frame.shape[:2]
    rejected = c1 | c2 | c3
    lines = []
    n_pass = n_rej = 0
    for k in range(len(iboxes)):
        x1, y1, x2, y2 = (int(v) for v in iboxes[k])
        if rejected[k]:
            fn = out_prefix + "%06d_r%u.jpg" % (frame_index, n_rej)
            n_rej += 1
            cv2.imwrite(osp.join(out_dir, "intermediate", "rejects", fn),
                        frame[max(0, y1): min(h, y2), max(0, x1): min(w, x2)])
        else:
            fn = out_prefix + "%06d_%u.jpg" % (frame_index, n_pass)
            n_pass += 1
        row = [fn, "%.2f" % scores[k], x2 - x1, y2 - y1, x1, y1, x2, y2,
               int(c1[k]), int(c2[k]), int(c3[k]), int(rejected[k])]
        lines.append(",".join(str(el) for el in row))

    log_fn = osp.join(out_dir, "intermediate", "log_rejects.csv")
    header_needed = not osp.exists(log_fn)
    with open(log_fn, "a") as f:
        if header_needed:
            f.write("file_name,score,width,height,x1,y1,x2,y2")
            f.write(",too_low(mscore=%s),too_small(msize=%u),too_close(mborder=%s),rejected\n"
                    % (str(min_score), min_size, str(min_border)))
        f.write("".join(line + "\n" for line in lines))


def adjust_boxes(iboxes, img_size, scale, square):
    """Scale about centers by (left, right, up, down) factors; optional squaring.

    Vectorized integer math matching detection.py:226-260 exactly, including
    the border-shift and final-shrink edge cases of the squaring step.
    """
    h, w = img_size
    if len(iboxes) == 0:
        return iboxes.copy()
    if isinstance(scale, (int, float)):
        scale = (scale, scale, scale, scale)
    sx1, sx2, sy1, sy2 = scale

    b = iboxes.astype(np.float64)
    bw = b[:, 2] - b[:, 0]
    bh = b[:, 3] - b[:, 1]
    xc = b[:, 0] + bw / 2
    yc = b[:, 1] + bh / 2
    x1 = np.floor(np.maximum(0, xc - sx1 * bw / 2)).astype(np.int64)
    x2 = np.ceil(np.minimum(w, xc + sx2 * bw / 2)).astype(np.int64)
    y1 = np.floor(np.maximum(0, yc - sy1 * bh / 2)).astype(np.int64)
    y2 = np.ceil(np.minimum(h, yc + sy2 * bh / 2)).astype(np.int64)

    if square:
        bw = x2 - x1
        bh = y2 - y1
        # grow the short side symmetrically (extra pixel goes right/bottom)
        def grow_and_shift(lo, hi, grow, limit):
            # symmetric growth (extra pixel to hi), then the two sequential
            # in-bounds shifts — each clamp applies only within its branch
            lo = lo - grow // 2
            hi = hi + (grow - grow // 2)
            under = lo < 0
            hi = np.where(under, np.minimum(limit, hi - lo), hi)
            lo = np.maximum(lo, 0)
            over = hi > limit
            lo = np.where(over, np.maximum(0, lo - (hi - limit)), lo)
            hi = np.minimum(hi, limit)
            return lo, hi

        tall = bh > bw
        x1, x2 = grow_and_shift(x1, x2, np.where(tall, bh - bw, 0), w)
        wide = bw > bh  # pre-squaring sizes, exclusive with `tall`
        y1, y2 = grow_and_shift(y1, y2, np.where(wide, bw - bh, 0), h)

        # final shrink: width can't exceed frame height and vice versa
        bw = x2 - x1
        bh = y2 - y1
        d = np.where(bw > h, bw - h, 0)
        x1 = x1 + d // 2
        x2 = x2 - (d - d // 2)
        d = np.where((bw <= h) & (bh > w), bh - w, 0)
        y1 = y1 + d // 2
        y2 = y2 - (d - d // 2)

    return np.stack([x1, y1, x2, y2], axis=1)
