"""The weight bridges in both directions: for YOLOv3, FaceNet, the ViT and
the ViT classifier, ``*_to_jax(*_from_jax(tree))`` is the JAX package's
tree again — the same keys, shapes and dtypes, bit for bit — and the
module built from the tree gives the tree back through its state dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from videotofaces_tpu.models import facenet as JF
from videotofaces_tpu.models import vit as JV
from videotofaces_tpu.models import yolo as JY
from videotofaces_tpu.train import trainer as JTR
from videotofaces_tpu_torch.models import facenet as TF
from videotofaces_tpu_torch.models import vit as TV
from videotofaces_tpu_torch.models import yolo as TY
from videotofaces_tpu_torch.train import trainer as TTR
from videotofaces_tpu_torch.utils import weights as W

SMALL_VIT = dict(img_size=32, patch_size=16, dim=64, depth=2)

CASES = {
    "yolo": (lambda: JY.YOLOv3(1), (1, 64, 64, 3), W.yolo_from_jax, W.yolo_to_jax,
             TY.YOLOv3.from_jax),
    "facenet": (JF.InceptionResnetV1, (1, 160, 160, 3), W.facenet_from_jax,
                W.facenet_to_jax, TF.InceptionResnetV1.from_jax),
    "vit": (lambda: JV.ViT(**SMALL_VIT), (1, 32, 32, 3), W.vit_from_jax, W.vit_to_jax,
            lambda p: TV.ViT.from_jax(p, **SMALL_VIT)),
    "classifier": (lambda: JTR.ViTClassifier(5, **SMALL_VIT), (1, 32, 32, 3),
                   W.classifier_from_jax, W.classifier_to_jax,
                   lambda p: TTR.ViTClassifier.from_jax(p, 5, **SMALL_VIT)),
}


def _random_tree(make, shape, seed):
    shapes = jax.eval_shape(make().init, jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_is_bit_exact(name):
    make, shape, from_jax, to_jax, build = CASES[name]
    tree = _random_tree(make, shape, 0)
    want = W.flatten(tree)
    for got_tree in (to_jax(from_jax(tree)), to_jax(build(tree).state_dict())):
        got = W.flatten(got_tree)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
