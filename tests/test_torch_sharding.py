"""The port's two-axis mesh and tensor-parallel sharding rules
(``videotofaces_tpu_torch/parallel/{mesh,sharding}.py``,
``train/trainer.py::classifier_param_spec``) against the JAX package's on
the CPU:

- ``make_mesh(n_data, n_model)`` puts the devices in JAX's grid order;
- the specs of every leaf of a ``ViTClassifier(5, img 32, dim 128, depth
  2)`` equal JAX's ``param_sharding_tree`` on a ``(4 x 2)`` mesh and on a
  ``(2 x 3)`` one, where 3 divides no width and every leaf falls back to
  replication; the port's state-dict names split along the dimension the
  JAX spec names (``jax_path``'s layout);
- ``shard_params`` places each block where JAX's sharded array keeps it;
- a 2-D mesh passed to an inference wrapper and to ``dedup_cosine``
  shards over ``"data"`` only and equals ``mesh=None``.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.parallel import make_mesh as jax_make_mesh
from videotofaces_tpu.parallel import sharding as JS
from videotofaces_tpu.train import trainer as JTR
from videotofaces_tpu_torch.models import vit as TV
from videotofaces_tpu_torch.models.wrappers import VitEncoder
from videotofaces_tpu_torch.ops import distances as D
from videotofaces_tpu_torch.parallel import make_mesh, shard_params, vit_param_spec
from videotofaces_tpu_torch.parallel import sharding as TS
from videotofaces_tpu_torch.train import trainer as TTR
from videotofaces_tpu_torch.utils.weights import flatten, jax_path

from test_torch_facenet import few_threads  # noqa: F401
from test_torch_vit import jax_vit_params

ARCH = dict(img_size=32, patch_size=16, dim=128, depth=2)
# (n_data, n_model): the JAX test's dp 4 x tp 2, and a model axis of 3
MESHES = [(4, 2), (2, 3)]


def jax_tree_shapes():
    return jax.eval_shape(JTR.ViTClassifier(5, **ARCH).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))["params"]


def jax_specs(n_data, n_model, rule):
    mesh = jax_make_mesh(n_data, n_model, jax.devices()[:n_data * n_model])
    tree = JS.param_sharding_tree(jax_tree_shapes(), mesh, rule)
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_make_mesh_has_jax_grid_order():
    devs = ["cpu"] * 8
    jmesh = jax_make_mesh(4, 2, jax.devices())
    mesh = make_mesh(4, 2, devs)
    assert mesh.shape == dict(jmesh.shape) == {"data": 4, "model": 2}
    assert mesh.axis_names == jmesh.axis_names
    assert mesh.devices.shape == jmesh.devices.shape and mesh.devices.size == 8
    # the order: device k of the list at [k // n_model, k % n_model]
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(ids, np.arange(8).reshape(4, 2))
    tagged = make_mesh(2, 2, ["cpu", "cpu", "cpu", "cpu"])
    assert tagged.grid == ((torch.device("cpu"),) * 2,) * 2
    assert make_mesh(None, 2, devs).shape == {"data": 4, "model": 2}
    assert make_mesh(3, 2, devs).devices.size == 6       # the first n_data x n_model
    one = make_mesh(devices=devs[:3])
    assert one.shape == {"data": 3} and one.axis_names == ("data",)
    with pytest.raises(ValueError):
        make_mesh(5, 2, devs)


@pytest.mark.parametrize("n_data,n_model", MESHES, ids=["4x2", "2x3"])
def test_classifier_specs_match_jax(n_data, n_model):
    want = jax_specs(n_data, n_model, JTR.classifier_param_spec)
    assert _port_specs(n_data, n_model) == want
    sharded = {k for k, s in want.items() if "model" in s}
    if n_model == 2:
        # q/k/v and fc1 kernels and biases, proj and fc2 kernels, per block
        assert len(sharded) == 10 * ARCH["depth"], sorted(sharded)
        assert want["backbone/block0/attn/q/kernel"] == (None, "model")
        assert want["backbone/block1/mlp/fc1/bias"] == ("model",)
        assert want["backbone/block0/proj/kernel"] == ("model", None)
        assert want["backbone/block0/proj/bias"] == ()
        assert want["head/kernel"] == ()
    else:
        assert not sharded                             # 3 divides neither 128 nor 512


def _port_specs(n_data, n_model):
    """The port's ``param_sharding_tree`` of the same tree, flat."""
    mesh = make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))
    tree = TS.param_sharding_tree(jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                               jax_tree_shapes()),
                                  mesh, TTR.classifier_param_spec)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = v

    walk(tree, "")
    return out


@pytest.mark.parametrize("n_data,n_model", MESHES, ids=["4x2", "2x3"])
def test_vit_param_spec_matches_jax_on_every_path(n_data, n_model):
    """The bare ViT rule, on the backbone's paths and on paths it must not
    shard (a ``proj`` bias, a name holding ``attn`` outside ``/attn/``)."""
    for path in list(jax_specs(n_data, n_model, JTR.classifier_param_spec)) + [
            "block0/proj/bias", "attn/q/kernel", "x/attn/q/scale", "mlp/fc2/bias"]:
        parts = path.split("/")
        if parts[0] == "backbone":
            parts = parts[1:]
        assert vit_param_spec(parts) == tuple(JS.vit_param_spec(parts)), path


@pytest.mark.parametrize("n_data,n_model", MESHES, ids=["4x2", "2x3"])
def test_state_dict_names_split_where_jax_does(n_data, n_model):
    """``make_sharded_train_step`` splits each state-dict leaf of the port's
    classifier along the torch dimension that holds the JAX spec's
    ``"model"`` dimension (dense kernels are transposed)."""
    want = jax_specs(n_data, n_model, JTR.classifier_param_spec)
    model = TTR.ViTClassifier(5, **ARCH)
    dims = TTR._split_dims(model, make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model)))
    assert len(dims) == len(want)
    for k, t in model.state_dict().items():
        path, perm = jax_path(k, t.dim())
        spec = want[path]
        jd = spec.index("model") if "model" in spec else None
        assert dims[k] == (None if jd is None else perm[jd]), k
    if n_model == 2:
        assert dims["backbone.block0.attn.q.weight"] == 0       # [out, in]: out split
        assert dims["backbone.block0.proj.weight"] == 1         # in split
        assert dims["backbone.block0.mlp.fc1.bias"] == 0


def test_shard_params_places_blocks_as_jax():
    """Each leaf's block on each device of the grid equals the shard JAX's
    ``shard_params`` keeps on the device of the same grid position."""
    params = jax_vit_params(1, dim=128, depth=1)
    jmesh = jax_make_mesh(4, 2, jax.devices())
    jsharded = JS.shard_params(params, jmesh)
    got = shard_params(params, make_mesh(4, 2, ["cpu"] * 8))
    pos = {d.id: divmod(k, 2) for k, d in enumerate(jmesh.devices.reshape(-1))}
    flat_j = jax.tree_util.tree_flatten_with_path(jsharded)[0]
    assert len(flat_j) == len(flatten(params))
    for path, arr in flat_j:
        node = got
        for p in path:
            node = node[str(p.key)]
        assert len(node) == 4 and all(len(row) == 2 for row in node)
        for shard in arr.addressable_shards:
            i, j = pos[shard.device.id]
            np.testing.assert_array_equal(node[i][j].numpy(), np.asarray(shard.data))
        # one copy per (device, block): the rows on the one CPU share it
        assert node[0][0] is node[3][0]


def test_two_axis_mesh_shards_inference_over_data(monkeypatch):
    """A ``(2 x 2)`` mesh given to a wrapper runs 2 data shards, each on its
    row's first device (the JAX package shards ``P("data")`` and replicates
    over ``"model"``), and equals ``mesh=None``; so does ``dedup_cosine``."""
    small = dict(dim=128, depth=2)
    monkeypatch.setattr(TV, "B16", dict(TV.B16, **small))
    params = jax_vit_params(3, **small)
    rng = np.random.default_rng(4)
    crops = [cv2.resize(rng.integers(0, 256, (6, 6, 3)).astype(np.uint8), (60 + 9 * i, 72),
                        interpolation=cv2.INTER_CUBIC) for i in range(5)]
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    want = VitEncoder("cpu", params=params)(crops)
    enc = VitEncoder(mesh=mesh, params=params)
    seen = []
    enc.model.register_forward_pre_hook(lambda mod, args: seen.append(args[0].shape[0]))
    got = enc(crops)
    assert seen == [3, 3] and enc.devices == mesh.shards and len(enc.models) == 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    x = torch.from_numpy(rng.normal(size=(37, 16)).astype(np.float32))
    x[20] = x[3] * 2.0
    for a, b in zip(D.dedup_cosine(x, mesh=mesh), D.dedup_cosine(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
