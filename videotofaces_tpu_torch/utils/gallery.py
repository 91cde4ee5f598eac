"""Notebook helpers: base64-inlined HTML image gallery and CSV-log viewer
(counterpart of videotofaces_tpu/utils/gallery.py; host code, no device).

Feature parity with the reference notebook utilities (utils/gallery.py:17-61):
``image_gallery`` renders a folder (with optional subfolders/paging) as an
HTML grid of inlined thumbnails; ``dataframe_with_images`` renders a pipeline
CSV log (log_rejects, log_dupesN, ...) as a pandas HTML table with embedded
images. IPython/pandas are imported lazily so the pipeline itself never
depends on them.
"""

import base64
import os
import os.path as osp

import cv2

from ..prep import IMG_EXTENSIONS, get_img_paths


def _img_tag(path, height):
    img = cv2.imread(path)
    if img is None:
        return ""
    if height:
        scale = height / img.shape[0]
        img = cv2.resize(img, (max(1, int(img.shape[1] * scale)), height))
    ok, buf = cv2.imencode(".jpg", img)
    if not ok:
        return ""
    b64 = base64.b64encode(buf.tobytes()).decode("ascii")
    return '<img src="data:image/jpeg;base64,%s" style="margin:2px"/>' % b64


def image_gallery(folder, height=100, page=1, per_page=200, subfolders=False):
    """Display a folder of images inline in a notebook (paged)."""
    from IPython.display import HTML, display

    if subfolders:
        paths = []
        for sub in sorted(e.name for e in os.scandir(folder) if e.is_dir()):
            paths.extend(get_img_paths(osp.join(folder, sub)))
    else:
        paths = get_img_paths(folder)
    total_pages = max(1, -(-len(paths) // per_page))
    page = min(max(1, page), total_pages)
    chunk = paths[(page - 1) * per_page: page * per_page]
    html = "<div>%u images, page %u/%u</div>" % (len(paths), page, total_pages)
    html += "".join(_img_tag(p, height) for p in chunk)
    display(HTML(html))


def dataframe_with_images(csv_path, img_dir=None, height=80, filter_expr=None,
                          sort_by=None, ascending=True):
    """Render a pipeline CSV log as a pandas table with inlined images for the
    file_name column. ``filter_expr`` is a pandas query string."""
    import pandas as pd
    from IPython.display import HTML, display

    df = pd.read_csv(csv_path)
    if filter_expr:
        df = df.query(filter_expr)
    if sort_by:
        df = df.sort_values(sort_by, ascending=ascending)
    img_dir = img_dir or osp.dirname(osp.abspath(csv_path))

    def render(fn):
        path = fn if osp.isabs(str(fn)) else osp.join(img_dir, str(fn))
        candidates = [path] + [osp.join(img_dir, sub, osp.basename(str(fn)))
                               for sub in ("rejects", "dupes1", "dupes2", "dupes3", "faces")]
        for c in candidates:
            if osp.isfile(c) and c.lower().endswith(IMG_EXTENSIONS):
                # a matched-but-unreadable file (corrupt jpg) yields an empty
                # tag — fall through to the filename so the row stays legible
                tag = _img_tag(c, height)
                if tag:
                    return tag
        return str(fn)

    cols = [c for c in df.columns if c.lower() in ("file_name", "nearest_in_prev",
                                                   "nearest_in_prev_5")]
    formatters = {c: render for c in cols}
    display(HTML(df.to_html(escape=False, formatters=formatters)))
