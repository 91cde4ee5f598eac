"""Frozen copy of the port's models/resnet.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import torch.nn.functional as F
from torch import nn

from .layers import ConvUnit

WIDTHS = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride=1, bn_eps=1e-5):
        super().__init__()
        cout = width * 4
        self.downsample = None
        if stride > 1 or cin != cout:
            self.downsample = ConvUnit(cin, cout, 1, stride, 0, None, bn_eps)
        self.u1 = ConvUnit(cin, width, 1, 1, 0, "relu", bn_eps)
        self.u2 = ConvUnit(width, width, 3, stride, 1, "relu", bn_eps)
        self.u3 = ConvUnit(width, cout, 1, 1, 0, None, bn_eps)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        return (self.u3(self.u2(self.u1(x))) + shortcut).relu()


class ResNet(nn.Module):
    """Returns [C2 (1/4), C3, C4, C5 (1/32)]; ``block_counts`` per stage."""

    def __init__(self, block_counts=(3, 4, 6, 3), bn_eps=1e-5):
        super().__init__()
        self.block_counts = tuple(block_counts)
        self.stem = ConvUnit(3, 64, 7, 2, 3, "relu", bn_eps)
        cin = 64
        for li, (n, w) in enumerate(zip(self.block_counts, WIDTHS)):
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                self.add_module(f"layer{li + 1}_block{bi}", Bottleneck(cin, w, stride, bn_eps))
                cin = w * 4

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)
        outs = []
        for li, n in enumerate(self.block_counts):
            for bi in range(n):
                x = getattr(self, f"layer{li + 1}_block{bi}")(x)
            outs.append(x)
        return outs
