"""The port's public callables keep the JAX package's argument positions:
every parameter of the JAX callable comes first, in order, with the same
name, kind and default; what only the port has (``device``) comes after
them, keyword-only on the callables whose ``device`` once sat in a JAX
slot. The fine-tune loops take a ``mesh`` at the JAX slot and run
sharded over it."""

import importlib
import inspect

import numpy as np
import pytest

P = inspect.Parameter

# every module of the JAX package with a counterpart in the port whose public
# callables users call (the models' layer classes are flax modules there and
# nn.Modules here: another calling convention, held by the parity tests)
MODULES = ("api", "serve", "specs", "prep", "config", "models.wrappers",
           "pipeline.detection", "pipeline.grouping", "pipeline.dupes",
           "pipeline.boxfilter", "pipeline.mesh_auto", "parallel.mesh",
           "parallel.multihost", "ops.anchors", "ops.boxes", "ops.cluster_scores",
           "ops.distances", "ops.kmeans", "ops.nms", "ops.resize", "ops.roi_align",
           "parallel.sharding", "train.detector", "train.triplet", "train.trainer",
           "utils.weights", "utils.gallery", "utils.download", "utils.image",
           "utils.profiling")
# functional JAX steps (params, opt_state, optax transforms) whose port
# counterparts take an nn.Module and an optimizer instead; so do the sharded
# step makers, whose params / opt_state / tx slots the module and the
# optimizer fill (the ViTClassifier is a flax module there)
FUNCTIONAL = {"train.detector": ("detection_loss", "detection_loss_full", "train_step",
                                 "train_step_full", "bn_stats_frozen", "layerwise_tx",
                                 "make_sharded_head_step", "make_sharded_full_step"),
              "train.triplet": ("triplet_loss", "triplet_loss_xbm", "train_step",
                                "train_step_xbm", "make_sharded_triplet_step",
                                "make_sharded_xbm_step"),
              "train.trainer": ("ViTClassifier", "create_train_state", "loss_fn", "train_step",
                                "make_sharded_train_step")}
# callables whose ``device`` took a JAX slot before: keyword-only now
KW_DEVICE = {("serve", "FaceService"), ("ops.kmeans", "kmeans_fit"),
             ("ops.cluster_scores", "silhouette_score"),
             ("train.triplet", "finetune_facenet"), ("train.detector", "finetune_yolo_head"),
             ("train.detector", "finetune_yolo_full")}


def _same_default(a, b):
    if a is P.empty or b is P.empty:
        return a is b
    if inspect.isfunction(a) and inspect.isfunction(b):
        return a.__name__ == b.__name__        # a rule function of each package
    if type(a).__module__.startswith(("jax", "numpy")) or \
            type(b).__module__.startswith("torch"):
        return str(np.dtype(a)) == str(b).replace("torch.", "")   # dtype defaults
    return repr(a) == repr(b)


def _mismatches(jax_fn, port_fn):
    js = list(inspect.signature(jax_fn).parameters.values())
    ts = list(inspect.signature(port_fn).parameters.values())
    bad = []
    for i, p in enumerate(js):
        if p.kind == P.VAR_KEYWORD:
            # the JAX wrapper forwards **kw; the port may name what it forwards
            if not any(q.kind == P.VAR_KEYWORD for q in ts[i:]):
                bad.append("no **kw")
            break
        q = ts[i] if i < len(ts) else None
        if q is None or (q.name, q.kind) != (p.name, p.kind) or \
                not _same_default(p.default, q.default):
            bad.append("slot %d: JAX %s, port %s" % (i, p, q))
    return bad


def _pairs(mod):
    jm = importlib.import_module("videotofaces_tpu." + mod)
    tm = importlib.import_module("videotofaces_tpu_torch." + mod)
    for name, jo in sorted(vars(jm).items()):
        if name.startswith("_") or getattr(jo, "__module__", None) != jm.__name__ or \
                name in FUNCTIONAL.get(mod, ()):
            continue
        to = getattr(tm, name, None)
        if inspect.isfunction(jo) and callable(to):
            yield name, jo, to
        elif inspect.isclass(jo) and inspect.isclass(to):
            yield name, jo.__init__, to.__init__
            for mname, meth in vars(jo).items():
                tmeth = getattr(to, mname, None)
                if not mname.startswith("_") and inspect.isfunction(meth) and \
                        inspect.isfunction(tmeth):
                    yield "%s.%s" % (name, mname), meth, tmeth


@pytest.mark.parametrize("mod", MODULES)
def test_port_callables_keep_the_jax_positions(mod):
    checked, bad = 0, []
    for name, jo, to in _pairs(mod):
        checked += 1
        bad += ["%s.%s: %s" % (mod, name, m) for m in _mismatches(jo, to)]
        if (mod, name) in KW_DEVICE:
            dev = inspect.signature(to).parameters["device"]
            if dev.kind != P.KEYWORD_ONLY:
                bad.append("%s.%s: device is not keyword-only" % (mod, name))
    assert checked, mod
    assert not bad, "\n".join(bad)


def test_the_six_repaired_signatures():
    from videotofaces_tpu_torch import serve
    from videotofaces_tpu_torch.ops import cluster_scores, kmeans
    from videotofaces_tpu_torch.train import detector, triplet

    def params(fn):
        return [(p.name, p.kind == P.KEYWORD_ONLY) for p in
                inspect.signature(fn).parameters.values()]

    assert params(serve.FaceService.__init__)[-6:] == [
        ("mesh", False), ("det_kw", False), ("enc_kw", False), ("detector", False),
        ("encoder", False), ("device", True)]
    assert params(kmeans.kmeans_fit)[-2:] == [("mesh", False), ("device", True)]
    assert params(cluster_scores.silhouette_score)[-2:] == [("mesh", False), ("device", True)]
    for fn in (triplet.finetune_facenet, detector.finetune_yolo_head,
               detector.finetune_yolo_full):
        names = [n for n, _ in params(fn)]
        assert names.index("mesh") + 1 == names.index("seed"), fn.__name__
        assert params(fn)[-1] == ("device", True), fn.__name__


def test_jax_positional_calls():
    """A JAX caller's positional arguments land where the JAX package puts
    them."""
    from videotofaces_tpu_torch.ops import cluster_scores as CS
    from videotofaces_tpu_torch.ops.kmeans import kmeans_fit
    from videotofaces_tpu_torch.serve import FaceService

    x = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    labels, centers, inertia = kmeans_fit(x, 3, 0, 300, 1e-4, None, device="cpu")
    want = kmeans_fit(x, 3, random_state=0, device="cpu")
    np.testing.assert_array_equal(labels, want[0])
    assert CS.silhouette_score(x, labels, 3, None, device="cpu") == \
        CS.silhouette_score(x, labels, n_clusters=3, device="cpu")

    class Det:
        batch_size = None

    class Enc:
        pass

    det, enc = Det(), Enc()
    svc = FaceService("live", "default", "default", None, 8, None, None, None, det, enc,
                      device="cpu")
    assert svc.detector is det and svc.encoder is enc and svc.max_batch == 8


@pytest.mark.parametrize("loop", ["finetune_facenet", "finetune_yolo_head",
                                  "finetune_yolo_full"])
def test_finetune_loops_accept_a_mesh(loop):
    """The JAX slot ``mesh`` runs the loop sharded (its results are held to
    the JAX loops in tests/test_torch_train_sharded*.py); a mesh beside a
    device, or on a device that does not exist, raises."""
    from videotofaces_tpu_torch.parallel import make_mesh
    from videotofaces_tpu_torch.train import detector, triplet

    fn = getattr(triplet if loop == "finetune_facenet" else detector, loop)
    data = (np.zeros((4, 16, 16, 3), np.uint8),
            [0, 0, 1, 1] if loop == "finetune_facenet" else [np.zeros((0, 4))] * 4)
    kw = dict(epochs=1, batch_size=3)
    if loop == "finetune_facenet":
        from torch import nn

        kw["model"] = nn.Sequential(nn.Conv2d(3, 4, 3), nn.Flatten(2), nn.AdaptiveAvgPool1d(1),
                                    nn.Flatten())
    else:
        kw["max_side"] = 32
    mesh = make_mesh(devices=["cpu"] * 2)
    tree, hist = fn(*data, mesh=mesh, **kw)
    assert len(hist) == 1 and np.isfinite(hist).all() and tree
    with pytest.raises(ValueError, match="not both"):
        fn(*data, mesh=mesh, device="cpu", **kw)
    with pytest.raises((RuntimeError, ValueError), match="CUDA device"):
        fn(*data, mesh=make_mesh(devices=["cuda:7"]), **kw)
