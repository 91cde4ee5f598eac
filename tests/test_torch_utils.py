"""The port's host utilities against the JAX package's: the notebook gallery
helpers (``image_gallery``, ``dataframe_with_images``, exported from the
package) must display identical HTML, and ``url_download`` must write the
same file from the same stubbed ``requests.Session`` responses, the Google
Drive confirm-token paths included. Nothing here reaches the network: the
session is a stub and sockets refuse to connect."""

import os
import os.path as osp
import socket

import cv2
import numpy as np
import pytest

import videotofaces_tpu as J
import videotofaces_tpu_torch as T
from videotofaces_tpu.utils import download as JD
from videotofaces_tpu_torch.utils import download as TD


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **kw):
        raise OSError("network access in a test")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.fixture
def shown(monkeypatch):
    """The HTML bodies passed to ``IPython.display.display``."""
    import IPython.display

    out = []
    monkeypatch.setattr(IPython.display, "display", lambda obj: out.append(obj.data))
    return out


@pytest.fixture(scope="module")
def gallery_dir(tmp_path_factory):
    """<root>/faces with 5 images, two group subfolders, a rejects folder, a
    corrupt jpg and a CSV log naming them."""
    root = tmp_path_factory.mktemp("gallery")
    rng = np.random.default_rng(2)
    faces = root / "faces"
    for sub in ("", "0", "1", "rejects"):
        os.makedirs(faces / sub, exist_ok=True)
    names = []
    for i in range(5):
        img = cv2.resize(rng.integers(0, 256, (6, 5, 3)).astype(np.uint8), (50 + 9 * i, 60),
                         interpolation=cv2.INTER_CUBIC)
        name = "f%02d.jpg" % i
        cv2.imwrite(str(faces / name), img)
        cv2.imwrite(str(faces / str(i % 2) / name), img)
        names.append(name)
    cv2.imwrite(str(faces / "rejects" / "r00.png"), np.full((30, 20, 3), 90, np.uint8))
    (faces / "broken.jpg").write_bytes(b"not a jpeg")
    (faces / "log.csv").write_text(
        "file_name,score,nearest_in_prev\n"
        + "".join("%s,%.2f,%s\n" % (n, 0.5 + 0.1 * i, names[i - 1] if i else "")
                  for i, n in enumerate(names))
        + "r00.png,0.10,f00.jpg\nbroken.jpg,0.20,missing.jpg\n")
    return str(faces)


@pytest.mark.parametrize("kw", [dict(), dict(height=40, page=2, per_page=2),
                                dict(subfolders=True, height=None), dict(page=9, per_page=3)],
                         ids=["defaults", "paged", "subfolders", "page_clamped"])
def test_image_gallery_same_html(gallery_dir, shown, kw):
    J.image_gallery(gallery_dir, **kw)
    T.image_gallery(gallery_dir, **kw)
    want, got = shown
    assert got == want
    assert got.count("<img ") > 0


@pytest.mark.parametrize("kw", [dict(), dict(filter_expr="score > 0.6", sort_by="score",
                                             ascending=False, height=30)],
                         ids=["defaults", "filtered_sorted"])
def test_dataframe_with_images_same_html(gallery_dir, shown, kw):
    csv = osp.join(gallery_dir, "log.csv")
    J.dataframe_with_images(csv, **kw)
    T.dataframe_with_images(csv, **kw)
    want, got = shown
    assert got == want
    assert "data:image/jpeg;base64," in got and "<table" in got


class _Response:
    """A streamed response: every ``iter_content`` continues one stream."""

    def __init__(self, chunks, cookies=None, length=True):
        self.stream = iter(chunks)
        self.cookies = cookies or {}
        body = sum(len(c) for c in chunks)
        self.headers = {"content-length": str(body)} if length else {}

    def iter_content(self, chunk_size):
        return self.stream

    def raise_for_status(self):
        pass


class _Session:
    """``requests.Session`` stand-in: answers each ``get`` with the next
    scripted response and records the calls."""

    def __init__(self, responses, calls):
        self.responses, self.calls = list(responses), calls

    def get(self, url, params=None, stream=False):
        self.calls.append((url, params, stream))
        return _Response(**self.responses.pop(0))


BODY = [b"chunk-one|", b"", b"chunk-two|", b"end"]
CASES = {   # gdrive, the session's responses in order
    "plain": (False, [dict(chunks=BODY)]),
    "plain_no_length": (False, [dict(chunks=BODY, length=False)]),
    "drive_cookie_token": (True, [dict(chunks=[b"<html>warning</html>"],
                                       cookies={"download_warning_abc": "tok"}),
                                  dict(chunks=BODY)]),
    "drive_confirm_page": (True, [dict(chunks=[b"<a href='?confirm=xyz'>go</a>"]),
                                  dict(chunks=BODY)]),
    "drive_direct": (True, [dict(chunks=BODY)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_url_download_streams_through_the_session(tmp_path, monkeypatch, case):
    import requests

    gdrive, responses = CASES[case]
    results = {}
    for name, mod in (("jax", JD), ("port", TD)):
        calls = []
        monkeypatch.setattr(requests, "Session",
                            lambda responses=responses, calls=calls: _Session(responses, calls))
        dst = str(tmp_path / (name + ".bin"))
        assert mod.url_download("https://example.invalid/file", dst, gdrive=gdrive) == dst
        with open(dst, "rb") as f:
            results[name] = (f.read(), calls)
    assert results["port"] == results["jax"]
    data, calls = results["port"]
    # the drive_direct case peeks the first chunk, then writes it before the rest
    assert data == b"".join(BODY)
    assert len(calls) == len(responses)
    if case.startswith("drive_") and case != "drive_direct":
        token = "tok" if case == "drive_cookie_token" else "t"
        assert calls[1] == ("https://example.invalid/file", {"confirm": token}, True)


def test_checkpoint_table_and_cached_fetch(tmp_path, monkeypatch):
    assert TD.TORCH_CHECKPOINT_URLS == JD.TORCH_CHECKPOINT_URLS
    cached = tmp_path / "facenet_vgg.pt"
    cached.write_bytes(b"x")
    monkeypatch.setattr(TD, "url_download", lambda *a, **kw: pytest.fail("downloaded"))
    assert TD.fetch_torch_checkpoint("facenet_vgg", str(tmp_path)) == str(cached)
