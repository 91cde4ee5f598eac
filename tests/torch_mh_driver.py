"""Subprocess driver for the port's multi-host tests: runs one "host" of a
(possibly) multi-host ``video_to_faces`` job of ``videotofaces_tpu_torch``
on the CPU with a small seeded YOLOv3 and a deterministic fake encoder.
Topology comes from V2F_PROCESS_INDEX/COUNT + V2F_GATHER_DIR (the
file-exchange transport), or, with ``--gloo <init file>``, from a gloo
process group that this script initializes (rank and world size from
V2F_RANK / V2F_WORLD). Imports nothing of JAX.

Usage: python torch_mh_driver.py <input_dir> <out_dir> <mode> [--gloo FILE]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)  # several hosts share the test machine's cores

from videotofaces_tpu_torch import api  # noqa: E402


class FakeEncoder:
    """Deterministic embedding = per-channel means + quadrant means of a
    fixed-resize gray image: stable across hosts, varied enough to cluster."""

    input_size = 32
    batch_size = None
    device = torch.device("cpu")

    def __call__(self, images):
        import cv2

        out = []
        for img in images:
            a = cv2.resize(img, (16, 16)).astype(np.float32)
            g = a.mean(axis=2)
            out.append(np.concatenate([
                a.mean(axis=(0, 1)),
                [g[:8, :8].mean(), g[:8, 8:].mean(), g[8:, :8].mean(), g[8:, 8:].mean()],
            ]))
        return np.asarray(out, np.float32)


def yolo_tree(seed=0):
    """A seeded YOLOv3 in the JAX layout whose heads' objectness and face
    biases are raised by 2, so random weights find boxes in noise."""
    from videotofaces_tpu_torch.models import yolo as Y
    from videotofaces_tpu_torch.utils.weights import yolo_to_jax

    model = Y.YOLOv3.seeded(seed)
    with torch.no_grad():
        for i in range(3):
            bias = getattr(model.head, "pred%d" % i).bias
            bias[4::6] += 2.0
            bias[5::6] += 2.0
    return yolo_to_jax(model.state_dict())


def main():
    input_dir, out_dir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
    if "--gloo" in sys.argv:
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method="file://" + sys.argv[sys.argv.index("--gloo") + 1],
            rank=int(os.environ["V2F_RANK"]), world_size=int(os.environ["V2F_WORLD"]))

    from videotofaces_tpu_torch.models.wrappers import YoloDetector
    import videotofaces_tpu_torch.pipeline.grouping as G

    params = yolo_tree()
    api.get_detector_model = lambda style, det, dev: YoloDetector(
        "cpu", params=params, max_side=96, batch_size=4)
    api.get_encoder_model = lambda style, enc, dev: FakeEncoder()
    # grouping.test_grouping & encode_refs use the module-level factory too
    G.get_encoder_model = api.get_encoder_model

    api.video_to_faces(
        input_path=input_dir, out_dir=out_dir, style="live", mode=mode, device="cpu",
        det_model="yolo", video_step=1, hash_thr=8, det_min_score=0.0,
        det_min_size=1, det_min_border=0, det_scale=(1.0, 1.0, 1.0, 1.0),
        det_square=False, clusters="3", group_mode="clustering",
        enc_dup_thr=-1, group_log=True)
    if "--gloo" in sys.argv:
        # a process that exits with its group alive may abort in gloo's teardown
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
