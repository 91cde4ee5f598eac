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

import copy

import numpy as np
import torch

from .. import config
from ..parallel.mesh import gather_rows, map_shards, split_rows


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
    ``torch._foreach_*`` ops, one pass per device): mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, the bias corrections 1 - b^count computed in
    float32 from float32 b (as XLA computes them: at count 1, 1 - f32(0.999)
    is 1.3e-5 below 0.001, which ``torch.optim.AdamW``'s float64
    corrections do not reproduce), u = mu_hat / (sqrt(nu_hat) + eps) +
    weight_decay * p, p += -lr * scale * u.

    Every leaf is set to require grad, as the JAX step differentiates them
    all. A step calls ``zero_grad()``, backpropagates, then ``step()``;
    ``step()`` leaves the (clipped) gradients in ``.grad`` and the global
    norm of the unclipped ones in ``grad_norm``. ``rebind`` moves the
    optimizer onto other tensors (a sharded step's placement)."""

    def __init__(self, named_leaves, learning_rate, weight_decay=1e-4, scale_of=None,
                 clip_norm=None):
        self.leaves, self.step_sizes, self.mu, self.nu = [], [], [], []
        for name, t in named_leaves:
            t.requires_grad_(True)
            self.leaves.append(t)
            scale = 1.0 if scale_of is None else scale_of(name)
            self.step_sizes.append(-learning_rate * scale)
            # mu and nu of each trained leaf; None where the scale is 0.0
            for state in (self.mu, self.nu):
                state.append(torch.zeros_like(t, requires_grad=False) if scale != 0.0
                             else None)
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.grad_norm = None

    def zero_grad(self):
        for t in self.leaves:
            t.grad = None

    @torch.no_grad()
    def rebind(self, placements):
        """Train other tensors in the leaves' place: ``placements[k]`` is
        ``(blocks, dim)`` for leaf k, its new tensors — the leaf itself
        moved (one block, ``dim`` None) or its blocks along ``dim``, in
        order, each on its device. Each leaf's mu and nu are split and moved
        alike; the count carries over."""
        leaves, steps, mu, nu = [], [], [], []
        for (blocks, dim), step, m, v in zip(placements, self.step_sizes, self.mu, self.nu,
                                             strict=True):
            if dim is None and len(blocks) != 1:
                raise ValueError("a leaf moved whole takes one block")
            for j, b in enumerate(blocks):
                b.requires_grad_(True)
                leaves.append(b)
                steps.append(step)
                for src, dst in ((m, mu), (v, nu)):
                    if src is not None and dim is not None:
                        src = src.tensor_split(len(blocks), dim)[j]
                    dst.append(None if src is None else src.contiguous().to(b.device))
        self.leaves, self.step_sizes, self.mu, self.nu = leaves, steps, mu, nu

    @torch.no_grad()
    def step(self):
        for t in self.leaves:
            if t.grad is None:          # a leaf the loss does not reach: JAX's zero
                t.grad = torch.zeros_like(t)
        grads = [t.grad for t in self.leaves]
        norm = torch.nn.utils.get_total_norm(grads)
        self.grad_norm = norm
        groups = _by_device(self.leaves)
        if self.clip_norm is not None:
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            # optax: (g / norm) * max_norm, computed without a host sync
            div, mul = torch.where(keep, one, norm), torch.where(keep, one, one * self.clip_norm)
            for dev, idx in groups.items():
                g = [grads[i] for i in idx]
                torch._foreach_div_(g, div.to(dev))
                torch._foreach_mul_(g, mul.to(dev))
        self.count += 1
        for idx in groups.values():
            idx = [i for i in idx if self.mu[i] is not None]
            if idx:
                self._adamw([self.leaves[i] for i in idx], [grads[i] for i in idx],
                            [self.mu[i] for i in idx], [self.nu[i] for i in idx],
                            [self.step_sizes[i] for i in idx])
        return norm

    def _adamw(self, p, g, mu, nu, step_sizes):
        one = np.float32(1.0)
        bc1 = float(one - np.float32(B1) ** np.float32(self.count))
        bc2 = float(one - np.float32(B2) ** np.float32(self.count))
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        del denom
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, step_sizes)
        torch._foreach_add_(p, u)


def _by_device(tensors):
    """{device: [index of a tensor on it]} in order of first appearance."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


class Replicas:
    """The copies a sharded step keeps of its trained leaves along a mesh's
    ``"data"`` axis: ``masters[k]`` is the tensor the optimizer updates,
    ``copies[k]`` its copies on the other devices that run a data shard
    (in shard order; shards on one device share a copy, and a shard on the
    master's device uses the master). After the single backward,
    ``reduce_grads`` adds each copy's gradient into its master's — a sum
    over ``"data"``, as XLA's gradient all-reduce — and after the update
    ``broadcast`` copies the masters' values back."""

    def __init__(self, masters, copies):
        self.masters, self.copies = list(masters), [list(c) for c in copies]

    def zero_grad(self):
        for cs in self.copies:
            for c in cs:
                c.grad = None

    @torch.no_grad()
    def reduce_grads(self):
        for m, cs in zip(self.masters, self.copies):
            for c in cs:
                if c.grad is not None:
                    g = c.grad.to(m.device)
                    m.grad = g if m.grad is None else m.grad + g

    @torch.no_grad()
    def broadcast(self):
        for m, cs in zip(self.masters, self.copies):
            for c in cs:
                c.copy_(m)


class ShardedStep:
    """What a ``make_sharded_*`` maker returns as its step:
    ``step(*batch)`` runs one step of the whole batch over the mesh;
    ``step.state_dict()`` is the trained model's state dict, every leaf
    whole on the mesh's first device."""

    def __init__(self, fn, state_dict):
        self._fn, self.state_dict = fn, state_dict

    def __call__(self, *batch):
        return self._fn(*batch)


def sharded_forward(mesh, models, fn, *batch):
    """``fn(module, *blocks)`` on each data shard of ``batch`` (tensors
    split on their first axis), with the module of the shard's device
    (``models``, from ``module_replicas``); the outputs — a tensor or a
    sequence of tensors — joined in shard order on the first shard device.
    ``.to()`` carries the gradient back to each shard's device."""
    outs = map_shards(mesh, lambda dev, *blocks: fn(models[dev], *(b.to(dev) for b in blocks)),
                      *(split_rows(b, mesh) for b in batch))
    dev0 = mesh.shards[0]
    if isinstance(outs[0], torch.Tensor):
        return gather_rows(outs, dev0)
    return [gather_rows([o[i] for o in outs], dev0) for i in range(len(outs[0]))]


def leaf_names(model, opt):
    """The state-dict names (in ``model``) of ``opt``'s leaves; raises when
    one is not a leaf of ``model``."""
    names = {id(t): k for k, t in leaves(model)}
    keys = [names.get(id(t)) for t in opt.leaves]
    if None in keys:
        raise ValueError("the optimizer's leaves are not the model's own tensors")
    return keys


@torch.no_grad()
def module_replicas(mesh, model, opt):
    """Data-parallel placement of ``model`` and ``opt`` on ``mesh``: the
    model moves to the first shard device (the master, whose leaves ``opt``
    is rebound to), and each other distinct shard device gets a copy of it.
    Returns ({device: module}, ``Replicas`` of the optimizer's leaves)."""
    keys = leaf_names(model, opt)
    dev0 = mesh.shards[0]
    model.to(dev0)
    master = dict(leaves(model))
    opt.rebind([([master[k]], None) for k in keys])
    models = {dev0: model}
    for d in mesh.distinct[1:]:
        models[d] = copy.deepcopy(model).to(d)
    copies = [[] for _ in keys]
    for d in mesh.distinct[1:]:
        own = dict(leaves(models[d]))
        for k, name in enumerate(keys):
            own[name].requires_grad_(True)
            copies[k].append(own[name])
    return models, Replicas([master[k] for k in keys], copies)


def check_batch(n, mesh):
    """A sharded step's batch must fill the ``"data"`` shards evenly."""
    if n % mesh.shape["data"]:
        raise ValueError("a batch of %d does not split over %d data shards"
                         % (n, mesh.shape["data"]))


def run_step(opt, loss_closure, replicas=None):
    """One training step under ``config.model_call()``: clear the
    gradients, ``loss, aux = loss_closure()``, backpropagate, ``opt.step()``.
    With ``replicas`` (a sharded step), the copies' gradients are added into
    the masters' before the update and the masters' values copied back after
    it. Returns (loss, aux) with the loss detached."""
    with config.model_call():
        opt.zero_grad()
        if replicas is not None:
            replicas.zero_grad()
        loss, aux = loss_closure()
        loss.backward()
        if replicas is not None:
            replicas.reduce_grads()
        opt.step()
        if replicas is not None:
            replicas.broadcast()
    return loss.detach(), aux


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
