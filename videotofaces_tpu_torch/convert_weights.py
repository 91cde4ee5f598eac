"""Torch checkpoint -> named npz converter of the port (counterpart of the
JAX package's tools/convert_weights.py; it imports nothing of JAX, so a
machine that runs only the port makes its own checkpoints).

Run once per pretrained reference file:

    python -m videotofaces_tpu_torch.convert_weights yolo   path/to/yolov3_wider.pt
    python -m videotofaces_tpu_torch.convert_weights rcnn   path/to/mmdet_anime-face_faster-rcnn.pth
    python -m videotofaces_tpu_torch.convert_weights mtcnn  path/to/mtcnn_joined.pt
    python -m videotofaces_tpu_torch.convert_weights facenet_vgg   path/to/20180402-114759-vggface2.pt
    python -m videotofaces_tpu_torch.convert_weights facenet_casia path/to/20180408-102900-casia-webface.pt
    python -m videotofaces_tpu_torch.convert_weights vit_b  path/to/vit_anime_b16.pt
    python -m videotofaces_tpu_torch.convert_weights vit_l  path/to/vit_anime_l16.pt

Outputs <repo>/weights/<name>.npz (or ``-o PATH``), the file the model
wrappers of both packages load at init. Source tensors are consumed IN
ORDER against each model's ``torch_spec`` (the ordering contract the
reference relies on), with the layout transforms of
``utils.weights.convert_state``; the npz equals the JAX converter's for
the same checkpoint.
"""

import argparse
import os.path as osp

import numpy as np

MODELS = ("yolo", "rcnn", "mtcnn", "facenet_vgg", "facenet_casia", "vit_b", "vit_l")


def load_torch_tensors(path, sub=None, reorder=None, drop_suffixes=()):
    """The checkpoint's tensors in their stored order, as float32 numpy
    arrays. The reference's files hold pickled modules, so the load is not
    ``weights_only``: convert only checkpoints you trust."""
    import torch

    wd = torch.load(path, map_location="cpu", weights_only=False)
    if sub:
        wd = wd[sub]
    if hasattr(wd, "state_dict"):
        wd = wd.state_dict()
    items = [(k, v) for k, v in wd.items()
             if not any(k.endswith(s) for s in drop_suffixes)]
    if reorder:
        items = reorder(items)
    return [np.asarray(v.float().numpy() if hasattr(v, "float") else v)
            for _, v in items]


def mmdet_roi_reorder(items):
    """mmdet puts the RoI cls/reg FCs before the shared FCs; the reference's
    wconv (rcnn.py:159-166) moves the last 8 entries: [cls/reg, fc] -> [fc, cls/reg]."""
    head, tail = items[:-8], items[-8:]
    return head + tail[4:] + tail[:4]


def anime_vit_reorder(items, depth):
    """AnimeVIT.wconv (vit.py:112-127): drop text/decoder/mlm/fc heads, move
    positional_embedding before the class-token tail, and move each block's
    norms before its attention/mlp weights."""
    out = []
    for name, v in items:
        if any(s in name for s in ("text_embeddings", "decoder", "mlm_head",
                                   "model.fc", "class_head.1")):
            continue
        if "positional_embedding" in name:
            out.insert(len(out) - 2, (name, v))
        elif "norm1" in name:
            out.insert(len(out) - 8, (name, v))
        elif "norm2" in name:
            out.insert(len(out) - 4, (name, v))
        else:
            out.append((name, v))
    return out


def facenet_drop_logits(items):
    return [(k, v) for k, v in items if not k.startswith("logits.")]


def convert(model_name, pt_path, out_path=None):
    """Convert ``pt_path`` for ``model_name`` (one of ``MODELS``) and write
    the npz; returns its path."""
    from .utils import weights as W

    if model_name == "yolo":
        from .models.yolo import torch_spec

        flat = W.convert_state(torch_spec(), load_torch_tensors(pt_path))
        default = "yolov3_wider"
    elif model_name == "rcnn":
        from .models.rcnn import torch_spec

        body_spec, head_spec = torch_spec()
        tensors = load_torch_tensors(pt_path, sub="state_dict", reorder=mmdet_roi_reorder)
        flat_all = W.convert_state(body_spec + head_spec, tensors)
        head_paths = {el[1] for el in head_spec}
        flat = {("head/" if k.split("/")[0] in head_paths else "body/") + k: v
                for k, v in flat_all.items()}
        default = "frcnn_anime"
    elif model_name == "mtcnn":
        from .models.mtcnn import torch_spec

        flat = W.convert_state(torch_spec(), load_torch_tensors(pt_path))
        default = "mtcnn_joined"
    elif model_name in ("facenet_vgg", "facenet_casia"):
        from .models.facenet import torch_spec

        tensors = load_torch_tensors(pt_path, reorder=facenet_drop_logits,
                                     drop_suffixes=("num_batches_tracked",))
        flat = W.convert_state(torch_spec(), tensors)
        default = model_name
    elif model_name in ("vit_b", "vit_l"):
        from .models.vit import torch_spec

        depth = 12 if model_name == "vit_b" else 24
        tensors = load_torch_tensors(pt_path, reorder=lambda it: anime_vit_reorder(it, depth))
        flat = W.convert_state(torch_spec(depth), tensors)
        default = "vit_anime_" + ("b16" if model_name == "vit_b" else "l16")
    else:
        raise SystemExit(f"unknown model {model_name!r} (valid: {', '.join(MODELS)})")

    out_path = out_path or osp.join(W.weights_dir(), default + ".npz")
    W.save_npz(out_path, flat)
    print(f"wrote {len(flat)} tensors to {out_path}")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m videotofaces_tpu_torch.convert_weights")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("pt_path")
    ap.add_argument("-o", "--out")
    args = ap.parse_args(argv)
    convert(args.model, args.pt_path, args.out)


if __name__ == "__main__":
    main()
