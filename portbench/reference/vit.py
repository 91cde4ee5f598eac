"""Frozen copy of the port's models/vit.py for the benchmark's plain reference: plain
PyTorch, no hand-written kernel, nothing imported from the program. The
numerics follow the port's float32 "highest" path (the ViT-B/16 forward;
the tensor-parallel training path is left out)."""


import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm


class SelfAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)

    def forward(self, x):
        return attend(self.q(x), self.k(x), self.v(x), self.heads)


def attend(q, k, v, heads):
    """Multi-head attention of projected q, k, v [B, N, D] (``heads``
    heads of D / heads columns each) -> [B, N, D]."""
    b, n, d = q.shape
    hd = d // heads

    def split(t):            # [B, N, D] -> [B, H, N, hd]
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    att = torch.softmax(split(q) @ split(k).transpose(-1, -2) * hd ** -0.5, dim=-1)
    return (att @ split(v)).transpose(1, 2).reshape(b, n, d)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp, eps=1e-12):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = SelfAttention(dim, heads)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.proj(self.attn(self.norm1(x)))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Returns the LayerNorm'd class-token embedding: [B, dim]."""

    def __init__(self, img_size=128, patch_size=16, dim=768, depth=12, heads=12, mlp=3072,
                 eps=1e-12):
        super().__init__()
        n = img_size // patch_size
        self.depth = depth
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n * n + 1, dim))
        self.patch_embedding = nn.Conv2d(3, dim, patch_size, patch_size)
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads, mlp, eps))
        self.norm = LayerNorm(dim, eps)

    def forward(self, x):
        x = self.patch_embedding(x).flatten(2).transpose(1, 2)    # [B, n*n, dim], row-major
        x = torch.cat([self.class_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embedding
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            x = block(x)
        return self.norm(x[:, 0])
