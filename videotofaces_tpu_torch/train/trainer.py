"""Fine-tune the ViT face encoder as a classifier (counterpart of
videotofaces_tpu/train/trainer.py): ViT backbone + linear head, mean
softmax cross-entropy on integer labels, AdamW. ``remat`` recomputes each
transformer block's activations in the backward pass instead of keeping
them (``torch.utils.checkpoint``), trading one more forward for memory.

Images are NCHW float32 [B, 3, H, W] here (the JAX package takes NHWC).
The step runs under ``config.model_call()``: TF32 follows the calling
thread's precision name.

``make_sharded_train_step`` is the step over a ``("data", "model")`` mesh
(parallel/mesh.py) in one process: the batch split over ``"data"``,
Megatron-style tensor parallelism over ``"model"`` inside each block
(``ViT.tp_forward``, the leaves split by ``classifier_param_spec``), the
logits gathered on the mesh's first device for one loss over the whole
batch and one backward, the gradients summed over ``"data"``, one AdamW
update, and the updated leaves copied to the other rows.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import init_uniform_fan_in_
from ..models.vit import ViT
from ..parallel.mesh import gather_rows, map_shards, split_rows
from ..parallel.sharding import fit_spec, model_dim, vit_param_spec
from ..utils.weights import classifier_from_jax  # noqa: F401 — the tree bridge, exported here
from ..utils.weights import jax_path
from .optim import AdamW, Replicas, ShardedStep, check_batch, leaf_names, leaves, run_step


class ViTClassifier(nn.Module):
    """ViT backbone + linear classification head; module names follow the
    JAX tree ``{"backbone", "head"}``."""

    def __init__(self, num_classes, img_size=128, patch_size=16, dim=768, depth=12,
                 remat=False):
        super().__init__()
        self.remat = remat
        self.backbone = ViT(img_size, patch_size, dim, depth)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x):
        return self.head(self.backbone(x, remat=self.remat))

    def tp_forward(self, p, x, devices):
        """``forward`` with tensor-parallel blocks on the weights in ``p``
        (``ViT.tp_forward``; the head is replicated)."""
        sub = {k[len("backbone."):]: v for k, v in p.items() if k.startswith("backbone.")}
        emb = self.backbone.tp_forward(sub, x, devices, self.remat)
        return F.linear(emb, p["head.weight"][0], p["head.bias"][0])

    @classmethod
    def from_jax(cls, params_np, num_classes, **kw):
        """Build from the JAX package's ``{"backbone", "head"}`` tree (numpy
        arrays); ``num_classes`` and the ViT's width must match it."""
        model = cls(num_classes, **kw)
        model.load_state_dict(classifier_from_jax(params_np), strict=True)
        return model

    @classmethod
    def seeded(cls, num_classes, seed=0, **kw):
        """Random weights from an explicit ``torch.Generator``
        (``init_uniform_fan_in_``)."""
        return init_uniform_fan_in_(cls(num_classes, **kw), seed)


def create_train_state(model, learning_rate=1e-4, weight_decay=1e-4):
    """``optax.adamw(learning_rate, weight_decay=weight_decay)`` over every
    leaf of ``model`` (``optim.AdamW``)."""
    return AdamW(leaves(model), learning_rate, weight_decay)


def loss_fn(model, images, labels):
    """(mean softmax cross-entropy on integer labels, accuracy)."""
    return _loss(model(images), labels)


def _loss(logits, labels):
    loss = F.cross_entropy(logits, labels.long())
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def train_step(model, opt, images, labels):
    """One step: forward, loss, backward, AdamW update of ``model`` in
    place. Returns (loss, accuracy) tensors."""
    return run_step(opt, lambda: loss_fn(model, images, labels))


def classifier_param_spec(path_parts):
    """Sharding rule for ``ViTClassifier``: the ViT rules under
    ``backbone``, the head replicated."""
    if path_parts and path_parts[0] == "backbone":
        return vit_param_spec(path_parts[1:])
    return ()


def _split_dims(model, mesh):
    """{state-dict name: the dimension its ``"model"`` blocks split, or
    None}, by ``classifier_param_spec`` on the JAX paths and shapes, with
    the JAX package's fallback to replication (``fit_spec``)."""
    dims = {}
    for k, t in leaves(model):
        path, perm = jax_path(k, t.dim())
        spec = fit_spec(classifier_param_spec(path.split("/")),
                        tuple(t.shape[i] for i in perm), mesh)
        jd = model_dim(spec)
        dims[k] = None if jd is None else perm[jd]
    return dims


def make_sharded_train_step(mesh, model, tx):
    """The classifier's step over ``mesh`` (``make_mesh(n_data,
    n_model)``; a ``("data",)`` mesh has one ``"model"`` device per row).
    ``model``: a ``ViTClassifier``; ``tx``: its optimizer
    (``create_train_state``), rebound here to the placed leaves.

    Each leaf is placed as ``_split_dims`` says: its blocks on every row's
    devices, block ``j`` on column ``j`` (one copy per distinct device), a
    replicated leaf on every row's first device; the first row's copies are
    the ones ``tx`` updates, AdamW's mu and nu with them. Returns (step,
    model, tx); ``step(images [B, 3, H, W], labels [B])`` -> (loss,
    accuracy), with B divisible by the ``"data"`` size (else it raises).
    The module's own tensors are not the placed ones: ``step.state_dict()``
    gathers the trained leaves on the mesh's first device."""
    if not isinstance(model, ViTClassifier):
        raise TypeError("make_sharded_train_step takes a ViTClassifier")
    keys = leaf_names(model, tx)
    trained = set(keys)
    dims = _split_dims(model, mesh)
    n = len(mesh.grid[0])
    views = [{} for _ in mesh.grid]            # per row: name -> [tensor per block]
    masters, copies = {}, {}
    with torch.no_grad():
        for k, t in leaves(model):
            dim = dims[k]
            blocks = [t.detach()] if dim is None else list(t.detach().tensor_split(n, dim))
            for j, b in enumerate(blocks):
                placed = {}
                for row, view in zip(mesh.grid, views):
                    d = row[j]
                    if d not in placed:
                        placed[d] = b.contiguous().to(d, copy=True).requires_grad_(k in trained)
                    view.setdefault(k, []).append(placed[d])
                master, *rest = placed.values()
                masters.setdefault(k, []).append(master)
                copies.setdefault(k, []).append(rest)
    tx.rebind([(masters[k], dims[k]) for k in keys])
    replicas = Replicas([m for k in keys for m in masters[k]],
                        [c for k in keys for c in copies[k]])
    dev0 = mesh.shards[0]

    def step(images, labels):
        check_batch(len(images), mesh)

        def closure():
            logits = map_shards(mesh, lambda dev, view, row, x: model.tp_forward(
                view, x.to(dev), row), views, mesh.grid, split_rows(images, mesh))
            return _loss(gather_rows(logits, dev0), labels.to(dev0))

        return run_step(tx, closure, replicas)

    def state_dict():
        return {k: (torch.cat([b.detach().to(dev0) for b in masters[k]], dims[k])
                    if dims[k] is not None else masters[k][0].detach())
                for k, _ in leaves(model)}

    return ShardedStep(step, state_dict), model, tx
