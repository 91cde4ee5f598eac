"""Streaming file downloader with Google-Drive confirm handling
(counterpart of videotofaces_tpu/utils/download.py).

Component parity with utils/download.py:10-40 in the reference: 1MB chunked
streaming with a progress bar, and the Drive "can't scan for viruses" confirm
page dance. ``fetch_torch_checkpoint`` pulls an original torch checkpoint
when the environment has network access; tools/convert_weights.py turns it
into the .npz the port's wrappers load from ``weights/``. ``requests`` is
imported only when a download starts.
"""

import os.path as osp

from .pbar import tqdm


def url_download(url, dst, gdrive=False, chunk_size=1024 * 1024):
    import requests

    session = requests.Session()
    resp = session.get(url, stream=True)
    first = b""
    if gdrive:
        token = next((v for k, v in resp.cookies.items()
                      if k.startswith("download_warning")), None)
        if token is None:
            # peek ONE chunk for the confirm interstitial — touching
            # resp.content on a streamed response would buffer the whole
            # (multi-GB) body into memory first
            first = next(resp.iter_content(chunk_size=4096), b"") or b""
            if b"confirm=" in first:
                token = "t"
                first = b""
        if token:
            resp = session.get(url, params={"confirm": token}, stream=True)
    resp.raise_for_status()

    total = int(resp.headers.get("content-length", 0)) or None
    with open(dst, "wb") as f, tqdm(total=total, unit="B", unit_scale=True,
                                    unit_divisor=1024) as bar:
        if first:
            f.write(first)
            bar.update(len(first))
        for chunk in resp.iter_content(chunk_size=chunk_size):
            if chunk:
                f.write(chunk)
                bar.update(len(chunk))
    return dst


# Original torch checkpoint sources (README.md:91-136 of the reference);
# convert with tools/convert_weights.py after downloading.
TORCH_CHECKPOINT_URLS = {
    "mtcnn_joined": "https://drive.google.com/uc?id=1qHW1xoTvuqlUBBhPx1ZLpzUXrWHfW1jN",
    "yolov3_wider": "https://drive.google.com/uc?id=1pjg1_IeAuzgRzZiY92r71uzd_amfcegu",
    "frcnn_anime": ("https://github.com/hysts/anime-face-detector/releases/download/"
                    "v0.0.1/mmdet_anime-face_faster-rcnn.pth"),
    "facenet_vgg": ("https://github.com/timesler/facenet-pytorch/releases/download/"
                    "v2.2.9/20180402-114759-vggface2.pt"),
    "facenet_casia": ("https://github.com/timesler/facenet-pytorch/releases/download/"
                      "v2.2.9/20180408-102900-casia-webface.pt"),
    "vit_anime_b16": "https://drive.google.com/uc?id=1hEtmrzlh7RrXuUoxi5eqMQd5yIirQ-XC",
    "vit_anime_l16": "https://drive.google.com/uc?id=1eZai1_gjos6TNeQZg6IY-cIWxtg0Pxah",
}


def fetch_torch_checkpoint(name, dst_dir):
    url = TORCH_CHECKPOINT_URLS[name]
    dst = osp.join(dst_dir, name + ".pt")
    if osp.isfile(dst):
        print("Using cached: " + dst)
        return dst
    print("Downloading %s\n  -> %s" % (url, dst))
    return url_download(url, dst, gdrive="drive.google" in url)
