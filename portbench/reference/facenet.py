"""Frozen copy of the port's models/facenet.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, ConvUnit


def cu(cin, cout, k, s=1, p=0):
    return ConvUnit(cin, cout, k, s, p, activ="relu", bn_eps=1e-3)


def max_pool(x):
    return F.max_pool2d(x, 3, 2)


class Block35(nn.Module):
    """Inception-A residual block at 256 channels."""

    def __init__(self, scale=0.17):
        super().__init__()
        self.scale = scale
        self.b0 = cu(256, 32, 1)
        self.b1_0, self.b1_1 = cu(256, 32, 1), cu(32, 32, 3, p=1)
        self.b2_0, self.b2_1, self.b2_2 = cu(256, 32, 1), cu(32, 32, 3, p=1), cu(32, 32, 3, p=1)
        self.out = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        y = torch.cat([self.b0(x), self.b1_1(self.b1_0(x)),
                       self.b2_2(self.b2_1(self.b2_0(x)))], dim=1)
        return torch.relu(self.out(y) * self.scale + x)


class Block17(nn.Module):
    """Inception-B residual block at 896 channels (1x7 / 7x1 factorized)."""

    def __init__(self, scale=0.1):
        super().__init__()
        self.scale = scale
        self.b0 = cu(896, 128, 1)
        self.b1_0 = cu(896, 128, 1)
        self.b1_1 = cu(128, 128, (1, 7), p=(0, 3))
        self.b1_2 = cu(128, 128, (7, 1), p=(3, 0))
        self.out = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        y = torch.cat([self.b0(x), self.b1_2(self.b1_1(self.b1_0(x)))], dim=1)
        return torch.relu(self.out(y) * self.scale + x)


class Block8(nn.Module):
    """Inception-C residual block at 1792 channels (1x3 / 3x1 factorized)."""

    def __init__(self, scale=0.2, relu=True):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.b0 = cu(1792, 192, 1)
        self.b1_0 = cu(1792, 192, 1)
        self.b1_1 = cu(192, 192, (1, 3), p=(0, 1))
        self.b1_2 = cu(192, 192, (3, 1), p=(1, 0))
        self.out = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        y = torch.cat([self.b0(x), self.b1_2(self.b1_1(self.b1_0(x)))], dim=1)
        y = self.out(y) * self.scale + x
        return torch.relu(y) if self.relu else y


class Mixed6a(nn.Module):
    """Reduction-A: 256 -> 896 channels, spatial /2."""

    def __init__(self):
        super().__init__()
        self.b0 = cu(256, 384, 3, s=2)
        self.b1_0, self.b1_1, self.b1_2 = cu(256, 192, 1), cu(192, 192, 3, p=1), cu(192, 256, 3, s=2)

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1_2(self.b1_1(self.b1_0(x))), max_pool(x)], dim=1)


class Mixed7a(nn.Module):
    """Reduction-B: 896 -> 1792 channels, spatial /2."""

    def __init__(self):
        super().__init__()
        self.b0_0, self.b0_1 = cu(896, 256, 1), cu(256, 384, 3, s=2)
        self.b1_0, self.b1_1 = cu(896, 256, 1), cu(256, 256, 3, s=2)
        self.b2_0, self.b2_1, self.b2_2 = cu(896, 256, 1), cu(256, 256, 3, p=1), cu(256, 256, 3, s=2)

    def forward(self, x):
        return torch.cat([self.b0_1(self.b0_0(x)), self.b1_1(self.b1_0(x)),
                          self.b2_2(self.b2_1(self.b2_0(x))), max_pool(x)], dim=1)


_STEM = [(3, 32, 3, 2, 0), (32, 32, 3, 1, 0), (32, 64, 3, 1, 1),
         (64, 80, 1, 1, 0), (80, 192, 3, 1, 0), (192, 256, 3, 2, 0)]


class InceptionResnetV1(nn.Module):
    """Returns L2-normalized [B, 512] embeddings."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout, k, s, p) in enumerate(_STEM):
            self.add_module(f"stem{i}", cu(cin, cout, k, s, p))
        for i in range(5):
            self.add_module(f"a{i}", Block35(0.17))
        self.red_a = Mixed6a()
        for i in range(10):
            self.add_module(f"b{i}", Block17(0.1))
        self.red_b = Mixed7a()
        for i in range(5):
            self.add_module(f"c{i}", Block8(0.2))
        self.c5 = Block8(1.0, relu=False)
        self.head = nn.Linear(1792, 512, bias=False)
        self.head_bn = BatchNorm(512, eps=1e-3)

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"stem{i}")(x)
        x = max_pool(x)
        for i in range(3, 6):
            x = getattr(self, f"stem{i}")(x)
        for i in range(5):
            x = getattr(self, f"a{i}")(x)
        x = self.red_a(x)
        for i in range(10):
            x = getattr(self, f"b{i}")(x)
        x = self.red_b(x)
        for i in range(6):
            x = getattr(self, f"c{i}")(x)
        x = x.mean(dim=(2, 3))                 # global average pool -> [B, 1792]
        x = self.head_bn(self.head(x))
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / torch.clamp(norm, min=1e-12)
