"""Fine-tune the ViT face encoder as a classifier (counterpart of
videotofaces_tpu/train/trainer.py): ViT backbone + linear head, mean
softmax cross-entropy on integer labels, AdamW. ``remat`` recomputes each
transformer block's activations in the backward pass instead of keeping
them (``torch.utils.checkpoint``), trading one more forward for memory.

Images are NCHW float32 [B, 3, H, W] here (the JAX package takes NHWC).
The step runs under ``config.model_call()``: TF32 follows the calling
thread's precision name. No mesh: the sharded step is not ported yet.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import init_uniform_fan_in_
from ..models.vit import ViT
from ..utils.weights import classifier_from_jax  # noqa: F401 — the tree bridge, exported here
from .optim import AdamW, leaves, run_step


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
    logits = model(images)
    loss = F.cross_entropy(logits, labels.long())
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def train_step(model, opt, images, labels):
    """One step: forward, loss, backward, AdamW update of ``model`` in
    place. Returns (loss, accuracy) tensors."""
    return run_step(opt, lambda: loss_fn(model, images, labels))
