"""The plain reference agrees with the port at tiny sizes on the CPU (the
port's CPU path runs the plain versions of its kernels), with one seeded
state given to both."""

import numpy as np
import pytest
import torch

from portbench import models, seeding, traffic
from portbench.reference import pipeline as RP

torch.set_num_threads(2)


def _frames(n=2, h=120, w=200, seed=0):
    spec = dict(size=[w, h], fps=4, seconds=n / 4 + 0.5, faces=3, face_px=[30, 70], variants=2,
                noise=3, quality=90, threads=2)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = traffic.make_clips(tmp, seed, dict(spec, clips=1))[0]
        return RP.read_frames(path, 0.25)[1][:n]


def _det_cfg(model):
    return {"detector": ({"model": "rcnn", "resize_spec": [96, 160], "proposal_cap": 64,
                          "out_top": 16, "calibrate": [
                              {"layer": "head.cls", "owner": "head", "face": 0,
                               "per_slot": True, "threshold": 0.4, "per_frame": 4}]}
                         if model == "rcnn" else
                         {"model": "mtcnn", "min_face_size": 24, "calibrate": [
                             {"layer": "pnet.cls", "owner": "pnet", "face": 1, "per_slot": False,
                              "threshold": 0.6, "per_frame": 40},
                             {"layer": "rnet.cls", "owner": "rnet", "face": 1, "per_slot": True,
                              "threshold": 0.7, "per_frame": 8},
                             {"layer": "onet.cls", "owner": "onet", "face": 1, "per_slot": True,
                              "threshold": 0.7, "per_frame": 4}]})}


@pytest.mark.parametrize("model", ["rcnn", "mtcnn"])
def test_detectors_agree(model):
    cfg = _det_cfg(model)
    frames = _frames()
    cpu = torch.device("cpu")
    state = models.detector_state(cfg, 11, cpu, frames)[0]
    det = models.program_detector(cfg, state, cpu)
    det.batch_size = 2
    out = det(frames)
    got = list(zip(out[0], out[1])) if isinstance(out, tuple) else [(o[:, :4], o[:, 4])
                                                                     for o in out]
    ref = models.reference_detector(cfg).eval()
    seeding.load_state_(ref, state)
    want = models.reference_detect(cfg, ref, frames, 2)
    assert sum(len(s) for _, s in want) > 0
    for (gb, gs), (wb, ws) in zip(got, want, strict=True):
        np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["rcnn", "mtcnn"])
def test_reference_kernel_inputs_are_the_programs(model, monkeypatch):
    """The inputs that the reference's stand-ins for K3 and K4 see, batch
    for batch (a short last batch padded as the program pads it), give
    the kernels' work that the program's own launches have; the traced
    runs count the kernels' work from them."""
    from portbench import flops

    cfg = _det_cfg(model)
    frames = _frames(n=3)
    cpu = torch.device("cpu")
    state = models.detector_state(cfg, 11, cpu, frames)[0]
    det = models.program_detector(cfg, state, cpu)
    det.batch_size = 2
    program = []
    if model == "mtcnn":
        from videotofaces_tpu_torch.models import mtcnn as PM

        fn, name = PM.pool_crops, "pool_crops"
        work = lambda bhw, slots, size: flops.crops_work(slots, size, *bhw)

        def keep(f, s, z):
            return tuple(f.shape[:3]), s.numpy().copy(), z
    else:
        from videotofaces_tpu_torch.models import rcnn as PM

        fn, name = PM.roi_align_fpn, "roi_align_fpn"
        work = lambda hw, c, esize, boxes, valid: flops.roi_work(boxes, valid, hw, c, esize)

        def keep(fmaps, boxes, valid, *rest):
            return ([tuple(f.shape[1:3]) for f in fmaps], fmaps[0].shape[-1],
                    fmaps[0].element_size(), boxes.clone(), valid.clone())

    def recording(*args):
        program.append(keep(*args))
        return fn(*args)

    monkeypatch.setattr(PM, name, recording)
    for k in range(0, len(frames), det.batch_size):     # as process_stream drives it
        det.collect(det.submit(frames[k:k + det.batch_size]))
    ref = models.reference_detector(cfg).eval()
    seeding.load_state_(ref, state)
    with models.kernel_inputs(cfg) as calls:
        models.reference_detect(cfg, ref, frames, 2)
    assert len(calls) == len(program) == (4 if model == "mtcnn" else 2)
    assert [work(*c) for c in calls] == [work(*c) for c in program]


@pytest.mark.parametrize("model", ["facenet", "vit"])
def test_encoders_agree(model):
    cfg = {"encoder": ({"model": "facenet", "input_size": 160, "norm_mean": 127.5,
                        "norm_scale": 1 / 128.0, "calibrate": "head_whiten",
                        "whiten_floor": 0.001} if model == "facenet" else
                       {"model": "vit", "arch": {"img_size": 128, "patch_size": 16, "dim": 768,
                                                 "depth": 2}, "input_size": 128,
                        "norm_mean": 127.5, "norm_scale": 1 / 127.5,
                        "calibrate": "center_norm"})}
    crops, _ = traffic.crop_images(3, {"n": 12, "identities": 3, "px": [50, 120],
                                       "dup_share": 0.0})
    import cv2
    s = cfg["encoder"]["input_size"]
    calib = [cv2.resize(c, (s, s), interpolation=cv2.INTER_LINEAR) for c in crops]
    cpu = torch.device("cpu")
    state = models.encoder_state(cfg, 5, cpu, calib)
    if model == "vit":
        from videotofaces_tpu_torch.models import vit as V
        from videotofaces_tpu_torch.models.wrappers import _Encoder
        net = V.ViT(**cfg["encoder"]["arch"])
        seeding.load_state_(net, state)
        enc = _Encoder(net, 128, V.preprocess_uint8, 1 / 127.5, 127.5, "cpu")
    else:
        enc = models.program_encoder(cfg, state, cpu)
    enc.batch_size = 4
    got = enc(crops)
    ref = models.reference_encoder(cfg).eval()
    seeding.load_state_(ref, state)
    want = models.reference_embed(cfg, ref, crops)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # the calibration spreads the embeddings: not every pair within the dedup threshold
    d = 1.0 - want @ want.T / np.outer(np.linalg.norm(want, axis=1), np.linalg.norm(want, axis=1))
    assert np.median(d[np.triu_indices(len(d), 1)]) > 0.25


def test_grouping_ops_agree():
    from videotofaces_tpu_torch.ops import cluster_scores as CS
    from videotofaces_tpu_torch.ops.kmeans import kmeans_fit
    from videotofaces_tpu_torch.pipeline.dupes import _nearest_earlier

    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1, (5, 32))
    x = centers[rng.integers(0, 5, 300)] + rng.normal(0, 0.3, (300, 32))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    x[7] = x[3] + 1e-3
    for k in (2, 3, 5):
        got = kmeans_fit(x, k, random_state=0, device="cpu")[0]
        want = RP.kmeans(x, k, 0)
        assert np.array_equal(got, want)
        assert abs(CS.silhouette_score(x, got, k, device="cpu") - RP.silhouette(x, want, k)) < 1e-6
    mins, _ = _nearest_earlier(x, "enc", "cpu")
    keep = mins > 0.25
    keep[0] = True
    assert np.array_equal(keep, RP.cosine_dedup_keep(x, 0.25))


def test_box_rules_and_hash_dedup_agree():
    from videotofaces_tpu_torch.pipeline import boxfilter as BF
    from videotofaces_tpu_torch.pipeline.dupes import remove_dupes_nearest
    from videotofaces_tpu_torch.specs import OutputLayout

    rng = np.random.default_rng(1)
    h, w = 120, 200
    boxes = np.stack([rng.uniform(-10, w, 200), rng.uniform(-10, h, 200)], 1)
    boxes = np.concatenate([boxes, boxes + rng.uniform(1, 90, (200, 2))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    ib = BF.round_out(boxes)
    assert np.array_equal(ib, RP.round_out(boxes))
    c1, c2, c3 = BF.check_conditions(ib, scores, (h, w), 0.4, 20, 5)
    assert np.array_equal(~(c1 | c2 | c3), RP.passes(ib, scores, (h, w), 0.4, 20, 5))
    for scale in ((1.5, 1.5, 2.2, 1.2), (1.0, 1.0, 1.0, 1.0), (3, 3, 3, 3)):
        got = BF.adjust_boxes(ib, (h, w), scale, True)
        want = np.array([RP.adjust_box(b, (h, w), scale, True) for b in ib])
        assert np.array_equal(got, want)
    frame = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    faces = [(frame[y:y + 40, x:x + 40].copy(), "f%d.jpg" % i)
             for i, (y, x) in enumerate(rng.integers(0, 60, (30, 2)))]
    faces += [(faces[3][0].copy(), "dup.jpg")]
    kept, _ = remove_dupes_nearest(faces, [], 8, OutputLayout(root="unused"))
    want = RP.window_dedup([(n, c) for c, n in faces], 8)
    assert [n for _, n in kept] == [n for n, _ in want]


def test_encoder_widths_of_the_configuration_are_the_programs():
    """The ViT widths that the anime configuration states (and its
    reference is built with) are those of the program's ViT-B/16."""
    from videotofaces_tpu_torch.models import vit as V

    from portbench import registry
    from portbench.reference.vit import ViT

    arch = registry.config("anime_rcnn_vitb16")["encoder"]["arch"]
    for net in (V.ViT(**V.B16), ViT(**arch)):
        blk = net.block0
        assert net.depth == arch["depth"]
        assert net.patch_embedding.out_channels == arch["dim"]
        assert net.patch_embedding.kernel_size == (arch["patch_size"],) * 2
        assert blk.attn.heads == arch["heads"]
        assert blk.mlp.fc1.out_features == arch["mlp"]
