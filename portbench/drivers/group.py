"""The ``group`` mix: repeated grouping jobs over one folder of face crops,
as ``video_to_faces(mode="grouping")`` runs them: ``encode_faces`` from
the JPEG files (the encoder's batches, host cv2 resize), the embedding
dedup (``remove_dupes_overall``), then the K-means sweep with the three
scores of each k and the best silhouette chosen (``kmeans_fit`` and
``ops/cluster_scores``, the calls ``cluster_faces`` makes; its file copies
into group folders are left out).

End to end: ``faces_per_s``, the crops of every job run in the window over
the window (which ends with the job that was running at the deadline).
``correct``: one job drawn from the seed. The reference embeds the crops
from the files on its own; the dedup and the sweep are judged by the
reference computing them from the program's embeddings."""

import os.path as osp
from contextlib import nullcontext
import shutil
import sys
import time

import cv2
import numpy as np
import torch

from .. import judge, models, precision, registry, seeding, traffic
from ..reference import pipeline as RP


def device_of(run):
    return torch.device(run.state.get("device", "cuda"))


def setup(run):
    from videotofaces_tpu_torch import config as V2F

    cfg, tr = run.config, run.traffic
    dev = device_of(run)
    V2F.set_precision(cfg["precision"])
    paths = traffic.make_crops(osp.join(run.scratch, "crops"), run.seed, tr["crops"])
    s = cfg["encoder"]["input_size"]
    calib = [cv2.resize(cv2.imread(p), (s, s), interpolation=cv2.INTER_LINEAR)
             for p in paths[:tr["calibration_images"]]]
    run.state["enc_state"] = models.encoder_state(cfg, run.seed, dev, calib)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.state["paths"] = paths
    run.state["enc"] = models.program_encoder(cfg, run.state["enc_state"], dev)
    _job(run, None)      # warm-up: every shape of a job


def _job(run, spans):
    """One grouping job; returns its outputs."""
    from videotofaces_tpu_torch import specs
    from videotofaces_tpu_torch.ops import cluster_scores as CS
    from videotofaces_tpu_torch.ops.kmeans import kmeans_fit
    from videotofaces_tpu_torch.pipeline.dupes import remove_dupes_overall
    from videotofaces_tpu_torch.pipeline.grouping import encode_faces

    tr = run.traffic
    enc, paths, dev = run.state["enc"], run.state["paths"], run.state["enc"].device
    # dedup's file removals land in an empty folder: the crops stay for the next job
    layout = specs.OutputLayout(root=osp.join(run.scratch, "job"))
    stage = spans.stage if spans is not None else (lambda name, items=0: nullcontext())
    with stage("harness:job", items=len(paths)):
        with stage("harness:encode", items=len(paths)):
            x = encode_faces(paths, enc, tr["enc_batch_size"], None)
        with stage("harness:dedup"):
            kept_x, kept = remove_dupes_overall(x, paths, "enc", tr["enc_dup_thr"], layout, dev)
        runs = []
        with stage("harness:sweep"):
            for k in tr["clusters"]:
                if k > len(kept):
                    continue
                labels = kmeans_fit(kept_x, k, random_state=tr["random_state"], device=dev)[0]
                runs.append((k, labels, CS.silhouette_score(kept_x, labels, k, device=dev),
                             CS.calinski_harabasz_score(kept_x, labels, k, device=dev),
                             CS.davies_bouldin_score(kept_x, labels, k, device=dev)))
            best = max(runs, key=lambda r: r[2]) if runs else None
    return {"x": x, "kept": kept, "kept_x": kept_x, "runs": runs,
            "best": None if best is None else best[0]}


def window(run):
    check_at = int(np.random.default_rng(run.seed).integers(0, run.traffic["check_among"]))
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    k, faces, checked = 0, 0, None
    while True:
        out = _job(run, run.spans)
        faces += len(run.state["paths"])
        if k <= check_at:
            checked = dict(out, job=k)
        k += 1
        if time.perf_counter() >= deadline:
            break
    elapsed = time.perf_counter() - t0
    run.state["checked"] = checked
    run.counts.update(jobs=k, faces=faces)
    run.attempted = faces
    run.e2e["faces_per_s"] = faces / elapsed


def release(run):
    run.state.pop("enc", None)


def check(run):
    cfg = run.config
    dev = device_of(run)
    chk = run.state["checked"]
    ref = models.reference_encoder(cfg).to(dev).eval()
    seeding.load_state_(ref, run.state["enc_state"])
    run.state["reference"] = ref
    run.state["check_crops"] = [cv2.imread(p) for p in run.state["paths"]]
    run.state["ref_emb"] = models.reference_embed(cfg, ref, run.state["check_crops"])
    values, best = _values(run, chk)
    print("portbench: checked job %d: %d crops, %d kept, k chosen %s (reference %s)"
          % (chk["job"], len(run.state["paths"]), len(chk["kept"]), chk["best"], best),
          file=sys.stderr)
    return judge.compare(values, registry.limits(run.name))


def _values(run, job):
    """The numbers of one job's outputs: its embeddings against the
    reference's, its dedup and its sweep against the reference's, computed
    from its own embeddings."""
    tr = run.traffic
    values = {"emb_gap_max": judge.embeddings(job["x"], run.state["ref_emb"])}
    keep = RP.cosine_dedup_keep(job["x"], tr["enc_dup_thr"])
    want = {p for p, k in zip(run.state["paths"], keep) if k}
    values["dedup_mismatch_share"] = (len(want ^ set(job["kept"]))
                                      / max(len(want | set(job["kept"])), 1))
    lab_gap, sil_gap, sils = 0.0, 0.0, {}
    for k, labels, sil, _, _ in job["runs"]:
        ref_labels = RP.kmeans(job["kept_x"], k, tr["random_state"])
        lab_gap = max(lab_gap, judge.label_mismatch_share(labels, ref_labels))
        sils[k] = RP.silhouette(job["kept_x"], labels, k)
        sil_gap = max(sil_gap, abs(float(sil) - sils[k]))
    values["label_mismatch_share"] = lab_gap
    values["silhouette_gap_max"] = sil_gap
    best = max(sils, key=sils.get) if sils else None
    values["chosen_k_differs"] = float(best != job["best"])
    return values, best


def control(run):
    """The numbers with the reference in TF32 in the program's place: its
    embeddings, then the job's dedup and sweep computed by the reference
    from them (after ``check``)."""
    tr, ref = run.traffic, run.state["reference"]
    with precision.tf32(ref):
        x = models.reference_embed(run.config, ref, run.state["check_crops"])
    keep = RP.cosine_dedup_keep(x, tr["enc_dup_thr"])
    kept_x = x[keep]
    runs = []
    for k in tr["clusters"]:
        if k <= len(kept_x):
            labels = RP.kmeans(kept_x, k, tr["random_state"])
            runs.append((k, labels, RP.silhouette(kept_x, labels, k), None, None))
    job = {"x": x, "kept_x": kept_x, "runs": runs,
           "kept": [p for p, k in zip(run.state["paths"], keep) if k],
           "best": max(runs, key=lambda r: r[2])[0] if runs else None}
    return _values(run, job)[0]


def work(run):
    """The encoder's model FLOPs over the window's faces."""
    from .. import flops

    ref = run.state["reference"]
    s = run.config["encoder"]["input_size"]
    dev = next(ref.parameters()).device
    per_face = flops.forward_ops(ref, lambda: ref(torch.zeros(1, 3, s, s, device=dev)))
    run.work["model_flops"] = per_face * run.counts["faces"]


def close(run):
    for key in ("enc", "reference", "check_crops", "ref_emb"):
        run.state.pop(key, None)
    shutil.rmtree(osp.join(run.scratch, "crops"), ignore_errors=True)
