"""The optimizer and the epoch loop of the training steps.

``AdamW`` computes what optax computes in the JAX package's training:
``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8 added after the square root,
eps_root 0, weight decay 1e-4 by default — ``torch.optim.AdamW``'s is
1e-2), with the labels of ``optax.multi_transform`` as per-leaf
learning-rate scales and ``optax.set_to_zero`` as scale 0.0 (neither
updated nor decayed), behind ``optax.clip_by_global_norm`` (``g * max_norm
/ norm`` when ``norm >= max_norm``; torch's ``clip_grad_norm_`` divides by
``norm + 1e-6``).

The leaves are those of the JAX parameter tree: a module's parameters and
its BatchNorm statistics (buffers here, flax params there). The JAX steps
differentiate every leaf, so the clip's global norm counts the statistics'
gradients and those of frozen modules, and a plain ``optax.adamw`` (the
FaceNet loop) trains the statistics too; ``AdamW`` does the same.
"""

import numpy as np
import torch

from .. import config


def leaves(module):
    """[(name, tensor)] of the module's parameters and buffers in state-dict
    order: the leaves of its JAX tree, as the module's own tensors."""
    return list(module.state_dict(keep_vars=True).items())


B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    """``optax.adamw(learning_rate * scale_of(name), weight_decay=...)`` per
    leaf of ``named_leaves`` (scale 0.0: the leaf stays as it is), behind
    ``optax.clip_by_global_norm(clip_norm)`` when ``clip_norm`` is set.

    The arithmetic is optax's, in float32 and in its order (multi-tensor
    ``torch._foreach_*`` ops): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 +
    b2 nu, the bias corrections 1 - b^count computed in float32 from
    float32 b (as XLA computes them: at count 1, 1 - f32(0.999) is 1.3e-5
    below 0.001, which ``torch.optim.AdamW``'s float64 corrections do not
    reproduce), u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p, p +=
    -lr * scale * u.

    Every leaf is set to require grad, as the JAX step differentiates them
    all. A step calls ``zero_grad()``, backpropagates, then ``step()``;
    ``step()`` leaves the (clipped) gradients in ``.grad`` and the global
    norm of the unclipped ones in ``grad_norm``."""

    def __init__(self, named_leaves, learning_rate, weight_decay=1e-4, scale_of=None,
                 clip_norm=None):
        self.leaves, self.trained, self.step_sizes = [], [], []
        for name, t in named_leaves:
            t.requires_grad_(True)
            self.leaves.append(t)
            scale = 1.0 if scale_of is None else scale_of(name)
            if scale != 0.0:
                self.trained.append(t)
                self.step_sizes.append(-learning_rate * scale)
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.mu = [torch.zeros_like(t, requires_grad=False) for t in self.trained]
        self.nu = [torch.zeros_like(t, requires_grad=False) for t in self.trained]
        self.count = 0
        self.grad_norm = None

    def zero_grad(self):
        for t in self.leaves:
            t.grad = None

    @torch.no_grad()
    def step(self):
        for t in self.leaves:
            if t.grad is None:          # a leaf the loss does not reach: JAX's zero
                t.grad = torch.zeros_like(t)
        grads = [t.grad for t in self.leaves]
        norm = torch.nn.utils.get_total_norm(grads)
        self.grad_norm = norm
        if self.clip_norm is not None:
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            # optax: (g / norm) * max_norm, computed without a host sync
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.clip_norm))
        if self.trained:
            self._adamw([t.grad for t in self.trained])
        return norm

    def _adamw(self, g):
        self.count += 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(B1) ** np.float32(self.count))
        bc2 = float(one - np.float32(B2) ** np.float32(self.count))
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, denom)
        del denom
        torch._foreach_add_(u, torch._foreach_mul(self.trained, self.weight_decay))
        torch._foreach_mul_(u, self.step_sizes)
        torch._foreach_add_(self.trained, u)


def run_step(opt, loss_closure):
    """One training step under ``config.model_call()``: clear the
    gradients, ``loss, aux = loss_closure()``, backpropagate, ``opt.step()``.
    Returns (loss, aux) with the loss detached."""
    with config.model_call():
        opt.zero_grad()
        loss, aux = loss_closure()
        loss.backward()
        opt.step()
    return loss.detach(), aux


def refuse_mesh(mesh):
    """The fine-tune loops take the JAX loops' ``mesh`` slot; a sharded
    loop (the global step over a data mesh) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel fine-tuning (mesh=) is not ported; see ROADMAP.md, item 11d")


def run_epochs(n, epochs, batch_size, seed, run_batch):
    """The JAX fine-tune loops' schedule: each epoch takes
    ``np.random.default_rng(seed).permutation(n)`` (one generator over all
    epochs), drops the ragged tail, and calls ``run_batch(indices)``, which
    returns the step's loss tensor. Returns the history of per-epoch mean
    losses (one host sync per epoch)."""
    rng = np.random.default_rng(seed)
    history = []
    for _ in range(epochs):
        order = rng.permutation(n)
        losses = [run_batch(order[i:i + batch_size])
                  for i in range(0, n - batch_size + 1, batch_size)]
        history.append(sum(float(v) for v in losses) / max(len(losses), 1))
    return history
