"""The numbers that decide ``correct``: what the program produced against
what the plain reference produced from the same inputs. Each function
returns plain floats; ``compare`` pairs them with the cell's limits
(``limits/<cell>.json``)."""

import numpy as np


def iou_matrix(a, b):
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = lambda z: np.clip(z[:, 2] - z[:, 0], 0, None) * np.clip(z[:, 3] - z[:, 1], 0, None)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def match(boxes_p, scores_p, boxes_r, scores_r, iou=0.5):
    """Greedy one-to-one matching of the program's detections (highest
    score first) to the reference's by IoU >= ``iou``. Returns the matched
    pairs as rows (score gap, box gap in pixels (largest coordinate
    difference), larger score of the two) and the unmatched count of both
    sides."""
    m = iou_matrix(boxes_p, boxes_r)
    taken = np.zeros(m.shape[1], bool)
    pairs = []
    for i in np.argsort(-np.asarray(scores_p), kind="stable"):
        if m.shape[1] == 0:
            break
        cand = np.where(taken, -1.0, m[i])
        j = int(np.argmax(cand))
        if cand[j] >= iou:
            taken[j] = True
            sp, sr = float(scores_p[i]), float(scores_r[j])
            pairs.append((abs(sp - sr),
                          float(np.abs(np.asarray(boxes_p[i], np.float64)
                                       - np.asarray(boxes_r[j], np.float64)).max()),
                          max(sp, sr)))
    unmatched = (len(scores_p) - len(pairs)) + (len(scores_r) - len(pairs))
    return pairs, unmatched


def detections(program, reference, min_score, iou=0.5):
    """Per-frame lists of (boxes, scores) on both sides -> the largest
    score gap and box gap (px) over all matched detections, the same over
    the matched detections that the box rules' score cut lets through on
    either side (``min_score``), the count of detections of either side
    left unmatched; and the detections compared."""
    pairs, unmatched, total = [], 0, 0
    for (bp, sp), (br, sr) in zip(program, reference, strict=True):
        p, u = match(bp, sp, br, sr, iou)
        pairs += p
        unmatched += u
        total += len(sp) + len(sr)
    g = np.asarray(pairs, np.float64).reshape(-1, 3)
    passing = g[g[:, 2] >= min_score]
    top = lambda col: float(col.max()) if len(col) else 0.0
    return {"score_gap_max": top(g[:, 0]), "box_gap_max": top(g[:, 1]),
            "pass_score_gap_max": top(passing[:, 0]), "pass_box_gap_max": top(passing[:, 1]),
            "unmatched": float(unmatched)}, total


def kept_crops(program, reference):
    """{name: crop} of both sides -> the count of names, of either side,
    missing on the other side or with other pixels."""
    names = set(program) | set(reference)
    return float(sum(1 for n in names if n not in program or n not in reference
                     or program[n].shape != reference[n].shape
                     or not np.array_equal(program[n], reference[n])))


def embeddings(program, reference):
    """[N, D] both sides -> the largest row's distance over the median row
    norm of the reference (unit rows: the largest L2 gap)."""
    p, r = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if p.shape != r.shape:
        return float("inf")
    return float(np.linalg.norm(p - r, axis=1).max() / np.median(np.linalg.norm(r, axis=1)))


def label_mismatch_share(a, b):
    """Share of points whose cluster id differs (1 when the two sides
    chose another number of clusters)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return 1.0
    return float(np.mean(a != b)) if len(a) else 0.0


def compare(values, limits):
    """{name: {"value", "limit"}} for every limited number, in the limits'
    order; a number without a value counts as infinitely far."""
    return {k: {"value": float(values.get(k, float("inf"))), "limit": float(lim["limit"])}
            for k, lim in limits["numbers"].items()}
