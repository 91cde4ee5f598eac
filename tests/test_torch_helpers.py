"""Public helpers of the JAX package that the port's slices had not taken,
each held to its JAX twin on the CPU: ``ops/boxes.py::scale_boxes``,
``ops/nms.py::batched_nms_topk`` (exact selection: equal to JAX wherever
its top-k has no ties), ``models/resnet.py::resnet152``,
``utils/profiling.py::sync`` / ``annotate``, and the names the JAX
``ops/__init__.py`` exports."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videotofaces_tpu.ops as JOPS
import videotofaces_tpu_torch.ops as TOPS
from videotofaces_tpu.models import resnet as JR
from videotofaces_tpu.ops import boxes as JB
from videotofaces_tpu.ops import nms as JN
from videotofaces_tpu_torch.models import resnet as TR
from videotofaces_tpu_torch.ops import boxes as TB
from videotofaces_tpu_torch.ops import nms as TN
from videotofaces_tpu_torch.utils import profiling as TP
from videotofaces_tpu_torch.utils.weights import flatten, state_dict_to_jax


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_scale_boxes_matches_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 300, (3, 7, 4)).astype(np.float32)
    target = np.asarray([[1080, 1920], [720, 1280], [480, 640]], np.float32)[:, None]
    current = np.asarray([[352, 608], [360, 640], [416, 544]], np.float32)[:, None]
    got = TB.scale_boxes(*(torch.from_numpy(a) for a in (boxes, target, current)))
    want = jax.jit(JB.scale_boxes)(boxes, target, current)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grouped", [False, True], ids=["one_group", "groups"])
def test_batched_nms_topk_matches_jax(grouped):
    rng = np.random.default_rng(1 + grouped)
    k = 64
    boxes = _boxes(rng, k, 60.0)
    scores = rng.permutation(k).astype(np.float32) / k          # no ties
    valid = rng.random(k) < 0.8
    groups = rng.integers(0, 3, k).astype(np.int32) if grouped else None
    got = TN.batched_nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(valid), 0.4, 48,
                              None if groups is None else torch.from_numpy(groups))
    want = JN.batched_nms_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.4,
                               48, None if groups is None else jnp.asarray(groups))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].any() and not got[3].all()          # kept boxes, then padding


def test_resnet152_matches_jax_layout():
    """Block counts (3, 8, 36, 3): the flax module's tree of leaf names and
    shapes, and its checkpoint spec."""
    model = TR.resnet152()
    assert model.block_counts == (3, 8, 36, 3)
    shapes = jax.eval_shape(JR.resnet152().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    want = {k: tuple(v.shape) for k, v in flatten(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes)).items()}
    got = {k: v.shape for k, v in flatten(state_dict_to_jax(
        {k: v for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")})).items()}
    assert got == want and len(got) > 600
    spec_j = JR.torch_spec((3, 8, 36, 3))
    spec_t = TR.torch_spec((3, 8, 36, 3))
    assert spec_t == spec_j and len(spec_t) > 150


def test_profiling_sync_and_annotate():
    x = torch.ones(3)
    assert TP.sync(x) is None and TP.sync({"a": [1, (x,)]}) is None and TP.sync([]) is None
    assert TP._first_tensor({"a": [1, (x,)]}) is x
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TP.annotate("v2f_span"):
            (x * 2).sum()
    assert any(e.name == "v2f_span" for e in prof.events())


def test_ops_package_exports_the_jax_names():
    names = [n for n in dir(JOPS) if not n.startswith("_") and callable(getattr(JOPS, n))]
    assert len(names) == 11, names
    missing = [n for n in names if not callable(getattr(TOPS, n, None))]
    assert not missing, missing
