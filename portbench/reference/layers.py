"""Frozen copy of the port's models/layers.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.Module):
    """Channelwise PReLU on axis 1: max(0, x) + a * min(0, x)."""

    def __init__(self, features):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x):
        a = self.alpha.view(1, -1, *([1] * (x.dim() - 2)))
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


class PConv(nn.Module):
    """Conv2d (VALID, stride 1, bias) + PReLU — the JAX package's
    ``ConvUnit(..., "prelu", bias=True)``; parameter names follow its tree
    (``conv.weight``, ``conv.bias``, ``prelu.alpha``)."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k)
        self.prelu = PReLU(cout)

    def forward(self, x):
        return self.prelu(self.conv(x))


class BatchNorm(nn.Module):
    """``(x - mean) / sqrt(var + eps) * scale + bias`` over axis 1 of an
    input of any rank, on the stored statistics (module docstring). Names
    follow ``nn.BatchNorm*``: ``weight``, ``bias`` (parameters),
    ``running_mean``, ``running_var`` (buffers)."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        mean, var = self.running_mean, self.running_var
        if torch.is_grad_enabled() and (mean.requires_grad or var.requires_grad):
            shape = (-1,) + (1,) * (x.dim() - 2)
            return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps)
                    * self.weight.view(shape) + self.bias.view(shape))
        return F.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0, self.eps)


class ConvUnit(nn.Module):
    """Conv2d + inference BatchNorm [+ residual add] [+ activation] — the
    JAX package's ``ConvUnit`` as the port's models use it. ``activ``: None,
    ``"relu"``, or ``"lrelu_0.1"`` (YOLO's leaky ReLU, ``where(x >= 0, x,
    0.1 * x)``). With ``bn_eps=None`` there is no BatchNorm and the
    convolution has a bias (the FPN laterals and smooths and the RPN conv).

    BatchNorm is ``BatchNorm``, ``(x - mean) / sqrt(var + eps) * scale +
    bias`` on the stored statistics in either mode; it is kept apart from
    the convolution (folding it in would change the rounding).
    Parameter names follow the JAX tree: ``conv.{weight, bias}``,
    ``bn.{weight, bias, running_mean, running_var}``."""

    def __init__(self, cin, cout, k, s=1, p=0, activ=None, bn_eps=1e-5):
        super().__init__()
        if activ not in (None, "relu", "lrelu_0.1"):
            raise ValueError(f"unsupported activation {activ!r}")
        self.conv = nn.Conv2d(cin, cout, k, s, p, bias=bn_eps is None)
        self.bn = None if bn_eps is None else BatchNorm(cout, bn_eps)
        self.activ = activ

    def forward(self, x, add=None):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if add is not None:
            x = x + add
        if self.activ == "relu":
            return torch.relu(x)
        if self.activ == "lrelu_0.1":
            return F.leaky_relu(x, 0.1)
        return x


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-12 by default (the ViT's):
    ``(x - mean) / sqrt(var + eps) * weight + bias``; the JAX tree's
    ``scale`` is ``weight`` here."""

    def __init__(self, features, eps=1e-12):
        super().__init__(features, eps=eps)
