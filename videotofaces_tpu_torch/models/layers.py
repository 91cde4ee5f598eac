"""Shared building blocks (counterpart of videotofaces_tpu/models/layers.py,
the parts MTCNN and FaceNet use). Maps are NCHW. The JAX package's
``max_pool2d`` is ``F.max_pool2d`` here (with ``ceil_mode=True`` for MTCNN:
the last window may run off the edge and takes the max over what is
inside)."""

import torch
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


class ConvUnit(nn.Module):
    """Conv2d (no bias) + inference BatchNorm [+ residual add] [+ ReLU] — the
    JAX package's ``ConvUnit`` as the port's models use it.

    BatchNorm is ``nn.BatchNorm2d`` in eval mode, ``(x - mean) /
    sqrt(var + eps) * scale + bias`` on the running statistics; it is kept
    apart from the convolution (folding it in would change the rounding).
    Parameter names follow the JAX tree: ``conv.weight``,
    ``bn.{weight, bias, running_mean, running_var}``."""

    def __init__(self, cin, cout, k, s=1, p=0, activ=None, bn_eps=1e-5):
        super().__init__()
        if activ not in (None, "relu"):
            raise ValueError(f"unsupported activation {activ!r}")
        self.conv = nn.Conv2d(cin, cout, k, s, p, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=bn_eps)
        self.activ = activ

    def forward(self, x, add=None):
        x = self.bn(self.conv(x))
        if add is not None:
            x = x + add
        return torch.relu(x) if self.activ == "relu" else x
