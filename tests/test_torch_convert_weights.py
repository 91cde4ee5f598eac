"""The port's checkpoint converter (videotofaces_tpu_torch/convert_weights.py,
``utils.weights.convert_state`` and each port model's ``torch_spec``)
against the JAX package's (tools/convert_weights.py): the same specs, the
same converted arrays bit for bit, the same npz from one ``torch.save``d
checkpoint, and full-size MTCNN and FaceNet checkpoints that load into the
port's modules."""

import importlib.util
import os.path as osp
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

from videotofaces_tpu.utils import weights as JW
from videotofaces_tpu_torch import convert_weights as TC
from videotofaces_tpu_torch.utils import weights as TW

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
MODELS = ("yolo", "rcnn", "mtcnn", "facenet_vgg", "facenet_casia", "vit_b", "vit_l")


def _jax_converter():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights", osp.join(ROOT, "tools", "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _specs(pkg, name):
    """(body, head) specs of ``name`` in package ``pkg`` (head empty but
    for the R-CNN)."""
    mod = lambda m: __import__("%s.models.%s" % (pkg, m), fromlist=["torch_spec"])  # noqa: E731
    if name == "rcnn":
        return mod("rcnn").torch_spec()
    if name.startswith("vit"):
        return mod("vit").torch_spec(12 if name == "vit_b" else 24), []
    return mod({"yolo": "yolo", "mtcnn": "mtcnn"}.get(name, "facenet")).torch_spec(), []


@pytest.mark.parametrize("name", MODELS + ("resnet",))
def test_specs_equal_the_jax_specs(name):
    if name == "resnet":
        from videotofaces_tpu.models import resnet as JR
        from videotofaces_tpu_torch.models import resnet as TR

        pairs = [(TR.torch_spec(), JR.torch_spec()),
                 (TR.torch_spec((1, 2), "x/"), JR.torch_spec((1, 2), "x/"))]
    else:
        got, want = _specs("videotofaces_tpu_torch", name), _specs("videotofaces_tpu", name)
        pairs = [(g, w) for g, w in zip(got, want) if g or w]   # the R-CNN's head too
    probe = np.arange(6, dtype=np.float32).reshape(2, 3)
    for got, want in pairs:
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            if g[0] == "param":    # kind, path, then the transform applied to an array
                assert g[:2] == w[:2]
                apply = lambda el: el[2](probe) if el[2] else probe  # noqa: E731
                np.testing.assert_array_equal(apply(g), apply(w))
            else:
                assert g == w


def _source_shape(el, rng_dims):
    """Tiny torch-layout shapes for one spec element's source tensors."""
    kind = el[0]
    o, i = rng_dims
    if kind == "conv":
        return [(o, i, 3, 1)] + ([(o,)] if el[2] else [])
    if kind == "bn":
        return [(o,)] * 4
    if kind == "linear":
        return [(o, i)] + ([(o,)] if el[2] else [])
    if kind == "linear_reshaped":
        return [(o, int(np.prod(el[2])))] + ([(o,)] if el[4] else [])
    if kind == "ln":
        return [(o,)] * 2
    return [(1, 2, o)]   # param


def _stream(spec, seed, scalars=True):
    """Seeded float32 tensors in spec order; a num_batches_tracked-style
    scalar after every BatchNorm (the converters skip them)."""
    rng = np.random.default_rng(seed)
    out = []
    for el in spec:
        for shape in _source_shape(el, (int(rng.integers(1, 4)), int(rng.integers(1, 4)))):
            out.append(rng.normal(size=shape).astype(np.float32))
        if scalars and el[0] == "bn":
            out.append(np.asarray(7, np.int64))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_converted_streams_equal_the_jax_converter(name):
    body, head = _specs("videotofaces_tpu_torch", name)
    tensors = _stream(body + head, seed=len(name))
    got = TW.convert_state(body + head, tensors)
    want = JW.convert_state(body + head, tensors)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="unconsumed"):
        TW.convert_state(body + head, tensors + [np.zeros(3, np.float32)])
    with pytest.raises(ValueError, match="ran out"):
        TW.convert_state(body + head, [t for t in tensors if t.ndim][:-1])


def _named_checkpoint(name, seed):
    """A state dict in the reference's stored order whose names exercise
    each converter's reordering: mmdet's RoI tail (cls/reg before the
    shared FCs), AnimeVIT's text/decoder heads and positional embedding and
    norms, FaceNet's ``logits`` and ``num_batches_tracked``."""
    body, head = _specs("videotofaces_tpu_torch", name)
    t = [torch.from_numpy(a) for a in _stream(body + head, seed, scalars=False)]
    if name == "rcnn":
        names = ["body.%04d" % k for k in range(len(t) - 8)]
        od = OrderedDict(zip(names, t[:-8]))
        fc, clsreg = t[-8:-4], t[-4:]       # spec order: fc0, fc1, cls, reg
        for k, v in zip(("cls.w", "cls.b", "reg.w", "reg.b", "fc0.w", "fc0.b", "fc1.w",
                         "fc1.b"), clsreg + fc):
            od["roi_head." + k] = v
        return {"state_dict": od, "meta": {"epoch": 12}}
    if name.startswith("vit"):
        od = OrderedDict([("class_token", t[0]), ("patch_embedding.weight", t[2]),
                          ("patch_embedding.bias", t[3]), ("positional_embedding", t[1]),
                          ("text_embeddings.weight", torch.ones(2, 2))])
        k = 4
        while k + 16 <= len(t) - 2:
            b = "blocks.%d." % ((k - 4) // 16)
            n1, qkvp, n2, mlp = t[k:k + 2], t[k + 2:k + 10], t[k + 10:k + 12], t[k + 12:k + 16]
            for j, v in enumerate(qkvp):
                od[b + "attn.%d" % j] = v
            od[b + "norm1.weight"], od[b + "norm1.bias"] = n1
            for j, v in enumerate(mlp):
                od[b + "mlp.%d" % j] = v
            od[b + "norm2.weight"], od[b + "norm2.bias"] = n2
            k += 16
        od["norm.weight"], od["norm.bias"] = t[-2:]
        od["decoder.weight"] = torch.ones(3)
        od["mlm_head.bias"] = torch.ones(3)
        od["model.fc.weight"] = torch.ones(2, 2)
        od["class_head.1.weight"] = torch.ones(2, 2)
        return od
    od = OrderedDict(("layer%04d" % k, v) for k, v in enumerate(t))
    if name.startswith("facenet"):
        od["layer0001.num_batches_tracked"] = torch.tensor(3)
        od["logits.weight"], od["logits.bias"] = torch.ones(5, 4), torch.ones(5)
    return od


@pytest.mark.parametrize("name", MODELS)
def test_port_converter_writes_the_jax_converters_npz(name, tmp_path):
    pt = str(tmp_path / (name + ".pt"))
    torch.save(_named_checkpoint(name, seed=3), pt)
    want_path = str(tmp_path / "jax.npz")
    _jax_converter().convert(name, pt, want_path)
    got_path = TC.convert(name, pt, str(tmp_path / "port.npz"))
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "rcnn":
        assert {k.split("/")[0] for k in want.files} == {"body", "head"}


def test_cli_runs_without_jax(tmp_path):
    """``python -m videotofaces_tpu_torch.convert_weights`` with JAX and the
    JAX package blocked from importing."""
    pt = str(tmp_path / "mtcnn.pt")
    torch.save(_named_checkpoint("mtcnn", seed=5), pt)
    code = ("import importlib.abc, runpy, sys\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'videotofaces_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "for k in list(sys.modules):\n"
            "    if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'videotofaces_tpu'):\n"
            "        del sys.modules[k]\n"
            "sys.meta_path.insert(0, Block())\n"
            "sys.argv = ['convert_weights', 'mtcnn', %r, '-o', %r]\n"
            "runpy.run_module('videotofaces_tpu_torch.convert_weights', run_name='__main__')\n"
            % (pt, str(tmp_path / "out.npz")))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "wrote" in out.stdout and osp.isfile(tmp_path / "out.npz")


def _reference_tensors(model, spec):
    """Source tensors in spec order with the real shapes: the port module's
    own parameters, seeded, back in the reference's torch layout."""
    flat = TW.flatten(TW.state_dict_to_jax(model.state_dict()))
    rng = np.random.default_rng(0)
    out = []
    for el in spec:
        path = el[1]
        keys = {"conv": ["kernel", "bias"], "linear": ["kernel", "bias"],
                "bn": ["scale", "bias", "mean", "var"], "param": [None]}[el[0]]
        for key in keys:
            if key == "bias" and el[0] in ("conv", "linear") and not el[2]:
                continue
            shape = flat[path if key is None else path + "/" + key].shape
            if key == "kernel":     # back to the torch layout
                shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2]) + shape[:2]
            out.append(rng.normal(size=shape).astype(np.float32))
    return out


@pytest.mark.parametrize("name", ["mtcnn", "facenet_vgg"])
def test_full_size_checkpoints_load_into_the_port(name, tmp_path):
    from videotofaces_tpu_torch.models import facenet as FN
    from videotofaces_tpu_torch.models import mtcnn as M

    cls, spec = (M.MTCNN, M.torch_spec()) if name == "mtcnn" else \
        (FN.InceptionResnetV1, FN.torch_spec())
    src = _reference_tensors(cls.seeded(0), spec)
    od = OrderedDict(("t%04d" % k, torch.from_numpy(v)) for k, v in enumerate(src))
    pt = str(tmp_path / "ref.pt")
    torch.save(od, pt)
    path = TC.convert(name, pt, str(tmp_path / (name + ".npz")))
    model = cls.from_jax(TW.load_params(path))   # through mtcnn_/facenet_from_jax
    # every source tensor lands in the module unchanged (torch layout in,
    # torch layout out), in the spec's order
    weights = [v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")]
    want = sorted((a.shape, a.tobytes()) for a in src)
    got = sorted((tuple(w.shape), w.numpy().tobytes()) for w in weights)
    assert got == want
