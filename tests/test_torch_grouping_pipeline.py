"""The full path by stages, the port against the JAX package on the same
seeded MTCNN and FaceNet parameters, on the CPU:

    detect_faces -> encode_faces -> remove_dupes_overall("enc", save_dupes)
                 -> cluster_faces  (and, on a copy, classify_faces)

Both must leave the same files in the same folders, and byte-identical CSVs
except for float columns, which are held to 1e-4."""

import os
import os.path as osp
import shutil

import cv2
import numpy as np
import pytest

from videotofaces_tpu.models import mtcnn as JM
from videotofaces_tpu.models.wrappers import FaceNetEncoder as JaxEncoder
from videotofaces_tpu.models.wrappers import MtcnnDetector as JaxDetector
from videotofaces_tpu.ops import distances as JD
from videotofaces_tpu.pipeline import detection as JDET
from videotofaces_tpu.pipeline import dupes as JDUP
from videotofaces_tpu.pipeline import grouping as JG
from videotofaces_tpu import specs as JS
from videotofaces_tpu_torch.models import mtcnn as TM
from videotofaces_tpu_torch.models.wrappers import FaceNetEncoder, MtcnnDetector
from videotofaces_tpu_torch.pipeline import detection as TDET
from videotofaces_tpu_torch.pipeline import dupes as TDUP
from videotofaces_tpu_torch.pipeline import grouping as TG
from videotofaces_tpu_torch import specs as TS

from test_torch_facenet import few_threads, jax_facenet_params  # noqa: F401
from test_torch_mtcnn_modules import jax_mtcnn_params

FPS, NFRAMES = 8.0, 4
CAPS = dict(pre1=128, post1=64, cross=256, stage2=64, stage3=32, out=8)
KS = [2, 3]
N_DUPES = 5          # the embedding-dedup threshold removes this many faces
OTHER_THR = 0.9
FLOAT_TOL = dict(rtol=1e-4, atol=1e-4 + 1e-9)


def _video(path):
    """A 160x120, 8-frame mp4 of smooth seeded noise."""
    rng = np.random.default_rng(31)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (160, 120))
    for _ in range(NFRAMES):
        low = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
        vw.write(cv2.resize(low, (160, 120), interpolation=cv2.INTER_CUBIC))
    vw.release()


def _threshold(x):
    """A dedup threshold halfway between the N_DUPES-th and next nearest-
    earlier distance, with a clear gap on both sides."""
    mins = np.sort(np.asarray(JD.dedup_cosine(x)[0])[1:])
    lo, hi = mins[N_DUPES - 1], mins[N_DUPES]
    assert hi - lo > 1e-3, "no clear gap for the threshold — reseed the test"
    return float((lo + hi) / 2)


def _run(pkg, root, video, mtcnn_params, facenet_params):
    """One package's stages. Returns (faces after detection, embeddings,
    survivors of the dedup, threshold) and leaves the clustered tree under
    ``root`` and the classified copy under ``root + "_cls"``."""
    if pkg == "jax":
        det = JaxDetector(params=mtcnn_params, min_face_size=12, caps=JM.Caps(**CAPS))
        enc = JaxEncoder(params=facenet_params)
        S, DET, DUP, G, dev = JS, JDET, JDUP, JG, {}
    else:
        det = MtcnnDetector(device="cpu", params=mtcnn_params, min_face_size=12,
                            caps=TM.Caps(**CAPS))
        enc = FaceNetEncoder(device="cpu", params=facenet_params)
        S, DET, DUP, G, dev = TS, TDET, TDUP, TG, {"device": "cpu"}
    paths = DET.detect_faces([video], det, S.FrameSampling(step=1.0 / FPS),
                             S.BoxCriteria(batch_size=4, min_score=0.4, min_size=10,
                                           min_border=0),
                             S.OutputLayout(root), 8)
    x = G.encode_faces(paths, enc, 16, None)
    thr = _threshold(x)
    kept_x, kept = DUP.remove_dupes_overall(x, paths, "enc", thr,
                                            S.OutputLayout(root, save_dupes=True), **dev)
    shutil.copytree(root, root + "_cls")
    cls_kept = [p.replace(root, root + "_cls") for p in kept]
    refs_dir = osp.join(root + "_cls", "refs")
    refs = []
    for name, src in (("alice", cls_kept[0]), ("bob", cls_kept[-1])):
        os.makedirs(osp.join(refs_dir, name))
        refs.append((name, [shutil.copy(src, osp.join(refs_dir, name))]))
    G.cluster_faces(kept, kept_x, S.ClusterSpec(KS, False, 0, True), root, **dev)
    G.classify_faces(cls_kept, kept_x, enc, S.ClassifySpec(refs, OTHER_THR, True),
                     root + "_cls")
    return paths, x, kept, thr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("stages")
    video = str(base / "clip.mp4")
    _video(video)
    mtcnn = jax_mtcnn_params(seed=0, cls_shift=2.0, reg_scale=1e-4)
    facenet = jax_facenet_params(seed=1, calibrate=True)
    return {pkg: (str(base / pkg),) + _run(pkg, str(base / pkg), video, mtcnn, facenet)
            for pkg in ("jax", "port")}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = osp.join(d, f)
            out[osp.relpath(p, root)] = open(p, "rb").read()
    return out


def _same_csv(got, want, roots):
    """Rows equal field by field, floats within FLOAT_TOL; each package's
    root directory (the dedup log names files by path, and the classified
    copy keeps the log of the original) reads as ``<root>``."""
    got, want = [t.decode().replace(r.removesuffix("_cls"), "<root>").splitlines()
                 for t, r in zip((got, want), roots)]
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        for a, b in zip(g.split(","), w.split(",")):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (g, w)
                continue
            assert np.isclose(fa, fb, **FLOAT_TOL), (g, w)


def _same_tree(root_got, root_want):
    got, want = _tree(root_got), _tree(root_want)
    assert sorted(got) == sorted(want)
    for rel in want:
        if rel.endswith(".csv"):
            _same_csv(got[rel], want[rel], (root_got, root_want))
        else:
            assert got[rel] == want[rel], rel


def test_same_faces_and_embeddings(runs):
    (_, jpaths, jx, _, _), (_, tpaths, tx, _, _) = runs["jax"], runs["port"]
    assert [osp.basename(p) for p in tpaths] == [osp.basename(p) for p in jpaths]
    assert len(jpaths) > N_DUPES + max(KS), "too few faces — reseed the test"
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-4)


def test_embedding_dedup_same_survivors(runs):
    (jroot, _, _, jkept, jthr), (troot, _, _, tkept, tthr) = runs["jax"], runs["port"]
    assert tthr == pytest.approx(jthr, abs=1e-4)
    assert [osp.basename(p) for p in tkept] == [osp.basename(p) for p in jkept]
    assert len(jkept) > max(KS)
    dupes = sorted(os.listdir(osp.join(troot, "intermediate", "dupes3")))
    assert len(dupes) == N_DUPES
    assert dupes == sorted(os.listdir(osp.join(jroot, "intermediate", "dupes3")))


def test_cluster_tree_matches_jax(runs):
    jroot, troot = runs["jax"][0], runs["port"][0]
    _same_tree(troot, jroot)
    groups = [d for d in os.listdir(osp.join(troot, "faces"))
              if osp.isdir(osp.join(troot, "faces", d))]
    assert len(groups) >= 2
    assert osp.isfile(osp.join(troot, "faces", "log_clustering.csv"))
    assert osp.isfile(osp.join(troot, "intermediate", "log_dupes3.csv"))


def test_classify_tree_matches_jax(runs):
    jroot, troot = runs["jax"][0] + "_cls", runs["port"][0] + "_cls"
    _same_tree(troot, jroot)
    log = open(osp.join(jroot, "faces", "log_classification.csv")).read().splitlines()
    dists = np.array([[float(v) for v in r.split(",")[1:3]] for r in log[1:]])
    # no face sits on the "other" threshold, so the open-set choice is stable
    assert np.abs(dists.min(axis=1) - OTHER_THR).min() > 1e-3
    assert sorted(d for d in os.listdir(osp.join(troot, "faces"))
                  if osp.isdir(osp.join(troot, "faces", d))) == ["alice", "bob", "other"]
