"""Checkpoint conversion, loading, and the parameter bridge from the JAX layout.

Converted checkpoints live in ``<repo>/weights/*.npz`` as flat "a/b/c" keys in
the JAX package's layout (HWIO conv kernels, [in, out] dense kernels). They
are made from the reference's torch checkpoints by the port's converter
(``python -m videotofaces_tpu_torch.convert_weights``), which consumes the
checkpoint's tensors IN ORDER against each model's ``torch_spec``: an
ordered list of typed elements (conv / bn / linear / raw param) with the
JAX package's tree paths, in the order the reference registers its
tensors; ``convert_state`` applies the layout transforms (OIHW -> HWIO
kernels, [out, in] -> [in, out] matrices) and skips scalar
``num_batches_tracked`` entries. The spec elements and ``convert_state``
are a copy of the JAX package's (utils/weights.py), so both converters
write the same npz. The port reads the same files and turns the nested
numpy tree into ``state_dict``s for its ``nn.Module``s with ``mtcnn_from_jax``,
``facenet_from_jax``, ``frcnn_from_jax``, ``vit_from_jax``, ``yolo_from_jax``
and ``classifier_from_jax``. ``state_dict_to_jax`` (as ``yolo_to_jax``,
``facenet_to_jax``, ``vit_to_jax`` and ``classifier_to_jax``) turns a state
dict back into the JAX tree, bit for bit, for the fine-tune loops' results.
"""

import os
import os.path as osp

import numpy as np
import torch


def unflatten(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def load_params(path, expected=None):
    """Load an .npz checkpoint into a nested numpy dict; validate names and
    shapes against an ``expected`` tree (arrays or shape tuples) if given."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if expected is not None:
        exp_flat = {k: tuple(np.shape(v)) if not isinstance(v, tuple) else v
                    for k, v in _flatten_any(expected).items()}
        missing = sorted(set(exp_flat) - set(flat))
        extra = sorted(set(flat) - set(exp_flat))
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing={missing[:5]} extra={extra[:5]}")
        for k, shape in exp_flat.items():
            if tuple(flat[k].shape) != shape:
                raise ValueError(f"shape mismatch at {k}: {flat[k].shape} vs {shape}")
    return unflatten(flat)


def _flatten_any(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten_any(v, key))
        else:
            flat[key] = v
    return flat


def weights_dir():
    """<repo>/weights — the directory the JAX package reads too."""
    home = osp.dirname(osp.dirname(osp.dirname(osp.realpath(__file__))))
    d = osp.join(home, "weights")
    os.makedirs(d, exist_ok=True)
    return d


# -- spec elements (the JAX package's utils/weights.py) -------------------------


def conv(path, bias=False):
    """torch Conv2d: weight [O, I, kh, kw] (+ bias [O]) -> kernel [kh, kw, I, O]."""
    return ("conv", path, bias)


def bn(path):
    """torch BatchNorm: weight, bias, running_mean, running_var
    (+ optional scalar num_batches_tracked, skipped)."""
    return ("bn", path)


def linear(path, bias=True):
    """torch Linear: weight [out, in] (+ bias) -> kernel [in, out]."""
    return ("linear", path, bias)


def linear_reshaped(path, src_shape, perm, bias=True):
    """torch Linear whose flattened input ordering differs from the JAX
    layout's: weight [out, prod(src_shape)] is unflattened to [out,
    *src_shape], the input dims permuted by ``perm`` (e.g. CHW -> HWC),
    re-flattened, then transposed. Used for FC layers that consume
    flattened conv maps (NCHW vs NHWC)."""
    return ("linear_reshaped", path, tuple(src_shape), tuple(perm), bias)


def ln(path):
    """torch LayerNorm: weight, bias -> scale, bias."""
    return ("ln", path)


def param(path, transform=None):
    """A raw tensor copied as-is (or via ``transform``)."""
    return ("param", path, transform)


def convunit(path, bias=False, has_bn=True):
    """A ConvUnit of the JAX layout: conv (+ bias) then optional BN."""
    els = [conv(f"{path}/conv", bias)]
    if has_bn:
        els.append(bn(f"{path}/bn"))
    return els


class _Source:
    """Ordered tensor stream with scalar-skip (num_batches_tracked etc.)."""

    def __init__(self, tensors):
        self.tensors = list(tensors)
        self.i = 0

    def next(self):
        while self.i < len(self.tensors) and np.asarray(self.tensors[self.i]).ndim == 0:
            self.i += 1  # skip num_batches_tracked-style scalars
        if self.i >= len(self.tensors):
            raise ValueError("source checkpoint ran out of tensors")
        t = np.asarray(self.tensors[self.i], dtype=np.float32)
        self.i += 1
        return t

    def done(self):
        while self.i < len(self.tensors) and np.asarray(self.tensors[self.i]).ndim == 0:
            self.i += 1
        return self.i >= len(self.tensors)


def convert_state(spec, tensors, strict=True):
    """Ordered source tensors + model spec -> flat {path: array} dict."""
    src = _Source(tensors)
    flat = {}
    for el in spec:
        kind = el[0]
        if kind == "conv":
            _, path, has_bias = el
            w = src.next()
            flat[f"{path}/kernel"] = np.transpose(w, (2, 3, 1, 0))
            if has_bias:
                flat[f"{path}/bias"] = src.next()
        elif kind == "bn":
            _, path = el
            flat[f"{path}/scale"] = src.next()
            flat[f"{path}/bias"] = src.next()
            flat[f"{path}/mean"] = src.next()
            flat[f"{path}/var"] = src.next()
        elif kind == "linear":
            _, path, has_bias = el
            w = src.next()
            flat[f"{path}/kernel"] = np.ascontiguousarray(w.T)
            if has_bias:
                flat[f"{path}/bias"] = src.next()
        elif kind == "linear_reshaped":
            _, path, src_shape, perm, has_bias = el
            w = src.next()
            out = w.shape[0]
            w = w.reshape((out,) + src_shape)
            w = np.transpose(w, (0,) + tuple(p + 1 for p in perm))
            flat[f"{path}/kernel"] = np.ascontiguousarray(w.reshape(out, -1).T)
            if has_bias:
                flat[f"{path}/bias"] = src.next()
        elif kind == "ln":
            _, path = el
            flat[f"{path}/scale"] = src.next()
            flat[f"{path}/bias"] = src.next()
        elif kind == "param":
            _, path, transform = el
            t = src.next()
            flat[path] = transform(t) if transform else t
        else:
            raise ValueError(f"unknown spec element {kind!r}")
    if strict and not src.done():
        raise ValueError(f"{len(tensors) - src.i} unconsumed source tensors")
    return flat


def save_npz(path, flat):
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


# -- the bridge from the JAX layout to the port's modules --------------------------


def jax_to_state_dict(tree):
    """One network's JAX-layout param tree -> a torch ``state_dict``.

    Keys "conv1/conv/kernel" become "conv1.conv.weight"; conv kernels go
    HWIO -> OIHW, dense kernels [in, out] -> [out, in]; biases and PReLU
    ``alpha`` copy as they are."""
    sd = {}
    for key, val in flatten(tree).items():
        val = np.asarray(val, np.float32)
        parts = key.split("/")
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if val.ndim == 4:
                val = val.transpose(3, 2, 0, 1)
            elif val.ndim == 2:
                val = val.T
            else:
                raise ValueError(f"unexpected kernel rank at {key}: {val.shape}")
        sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def _with_bn_names(sd, bn_parents):
    """Rename BatchNorm leaves {scale, bias, mean, var} under a parent named
    in ``bn_parents`` to {weight, bias, running_mean, running_var}."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if len(parts) > 1 and parts[-2] in bn_parents:
            parts[-1] = _BN_NAMES[parts[-1]]
        out[".".join(parts)] = val
    return out


def facenet_from_jax(params_np):
    """The JAX package's InceptionResnetV1 parameter tree (numpy arrays) ->
    the port's ``state_dict``: ``*/conv/kernel`` HWIO -> OIHW, the residual
    ``*/out/{kernel, bias}`` to a conv with bias, ``head/kernel`` [1792, 512]
    -> [512, 1792], and every BatchNorm (``*/bn``, ``head_bn``)
    ``{scale, bias, mean, var}`` -> ``{weight, bias, running_mean,
    running_var}``."""
    return _with_bn_names(jax_to_state_dict(params_np), ("bn", "head_bn"))


def mtcnn_from_jax(params_np):
    """The JAX package's MTCNN parameter tree (numpy arrays) -> the port's
    ``{"pnet", "rnet", "onet"}`` state dicts. The RNet/ONet dense layers
    consume maps flattened in (w, h, c) order on both sides, so their
    weights carry over with the plain transpose."""
    return {net: jax_to_state_dict(params_np[net])
            for net in ("pnet", "rnet", "onet")}


def frcnn_from_jax(params_np):
    """The JAX package's Faster R-CNN tree {"body", "head"} (numpy arrays) ->
    the port's ``{"body", "head"}`` state dicts. The anonymous ``ResNet_0``
    backbone becomes ``backbone``; the FPN's and the RPN's convolutions
    carry their biases; the RoI head's ``fc0`` consumes the pooled maps
    flattened in (7, 7, C) order on both sides, so its kernel carries over
    with the plain transpose."""
    body = {}
    for key, val in _with_bn_names(jax_to_state_dict(params_np["body"]), ("bn",)).items():
        if key.startswith("ResNet_0."):
            key = "backbone." + key[len("ResNet_0."):]
        body[key] = val
    return {"body": body, "head": jax_to_state_dict(params_np["head"])}


def vit_from_jax(params_np):
    """The JAX package's ViT tree (numpy arrays) -> the port's ``state_dict``:
    ``patch_embedding`` HWIO -> OIHW, dense kernels transposed, every
    LayerNorm ``scale`` -> ``weight``; ``class_token`` and
    ``pos_embedding`` as they are."""
    sd = {}
    for key, val in jax_to_state_dict(params_np).items():
        if key.endswith(".scale"):
            key = key[:-len("scale")] + "weight"
        sd[key] = val
    return sd


def yolo_from_jax(params_np):
    """The JAX package's YOLOv3 tree {"backbone", "neck", "head"} (numpy
    arrays) -> the port's ``state_dict``: ``*/conv/kernel`` HWIO -> OIHW,
    the heads' ``pred*/{kernel, bias}`` to convolutions with a bias, and
    every BatchNorm ``*/bn/{scale, bias, mean, var}`` -> ``{weight, bias,
    running_mean, running_var}``."""
    return _with_bn_names(jax_to_state_dict(params_np), ("bn",))


_JAX_NAMES = {"running_mean": "mean", "running_var": "var"}


def jax_path(key, ndim):
    """A port state-dict key and its leaf's rank -> (the JAX tree path
    "a/b/kernel", the permutation ``perm`` with ``jax_leaf =
    leaf.permute(perm)``): 4-d ``weight`` OIHW -> HWIO ``kernel``, 2-d
    ``weight`` [out, in] -> [in, out] ``kernel``, 1-d ``weight`` (a
    BatchNorm's or LayerNorm's) -> ``scale``, ``running_mean`` /
    ``running_var`` -> ``mean`` / ``var``; every other leaf as it is. The
    port names no other 1-d ``weight``, so the rule is the same for every
    model."""
    parts = key.split(".")
    perm = tuple(range(ndim))
    if parts[-1] == "weight":
        if ndim == 4:
            parts[-1], perm = "kernel", (2, 3, 1, 0)
        elif ndim == 2:
            parts[-1], perm = "kernel", (1, 0)
        else:
            parts[-1] = "scale"
    parts[-1] = _JAX_NAMES.get(parts[-1], parts[-1])
    return "/".join(parts), perm


def state_dict_to_jax(sd):
    """A port ``state_dict`` -> the JAX package's nested numpy tree (the
    names and layouts of ``jax_path``), the inverse of the ``*_from_jax``
    bridges; values are copied bit for bit in their dtype."""
    flat = {}
    for key, val in sd.items():
        val = val.detach().cpu().numpy()
        path, perm = jax_path(key, val.ndim)
        # a copy: ``numpy()`` of a CPU tensor shares its memory
        flat[path] = np.array(val.transpose(perm), order="C", copy=True)
    return unflatten(flat)


yolo_to_jax = facenet_to_jax = vit_to_jax = classifier_to_jax = state_dict_to_jax
# the ViTClassifier tree {"backbone", "head"}: vit_from_jax's rules cover both
classifier_from_jax = vit_from_jax
