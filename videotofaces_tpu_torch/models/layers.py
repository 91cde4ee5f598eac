"""Shared building blocks (counterpart of videotofaces_tpu/models/layers.py,
the parts MTCNN uses). Maps are NCHW. The JAX package's ceil-mode
``max_pool2d`` is ``F.max_pool2d(..., ceil_mode=True)`` here: the last
window may run off the edge and takes the max over what is inside."""

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

