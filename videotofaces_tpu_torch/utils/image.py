"""Small host-side image helpers (cv2); semantics match utils/image.py:4-22
of the reference (same int truncation, so crops/thumbnails are bit-identical)."""

import cv2


def fit_scale(hw, to_area):
    """Scale factor that fits an (h, w) image into ``to_area`` — (w, h), or a
    single int for a square — preserving aspect ratio."""
    h, w = hw
    tw, th = to_area if isinstance(to_area, (tuple, list)) else (to_area, to_area)
    return min(tw / w, th / h)


def resize_keep_ratio(img, to_area, upscale=True):
    """Resize to fit inside ``to_area``. ``upscale=False`` leaves images that
    already fit untouched."""
    s = fit_scale(img.shape[:2], to_area)
    if s == 1 or (s > 1 and not upscale):
        return img
    h, w = img.shape[:2]
    return cv2.resize(img, (int(w * s), int(h * s)))


def crop_to_area(img, area):
    """Fractional crop: ``area`` = (px1, py1, px2, py2), each in [0, 1] of the
    image's width/height. Used for ``enc_area``."""
    h, w = img.shape[:2]
    x1, x2 = int(area[0] * w), int(area[2] * w + 1)
    y1, y2 = int(area[1] * h), int(area[3] * h + 1)
    return img[y1:y2, x1:x2, :]
