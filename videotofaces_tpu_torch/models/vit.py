"""ViT encoder for anime face embeddings (counterpart of
videotofaces_tpu/models/vit.py): B16 dim 768 depth 12, L16 dim 1024 depth
24, 128 px inputs -> 64 patch tokens + the class token.

Architecture parity target: encoders/vit.py:9-102 of the reference — conv
patch embedding, class token, learned positional embeddings, pre-LN blocks
with separate q / k / v projections and the per-head attention scale
head_dim^-0.5, exact (erf) GELU, LayerNorm eps 1e-12, the final LayerNorm
applied to the class token only (no projection head). Attention is a
product, a softmax and a product, as the JAX package writes it (no Pallas
kernel exists there; at 65 tokens a fused kernel gains nothing). Module
names follow the JAX parameter tree (``block{i}/attn/{q,k,v}``, ``proj``,
``mlp/{fc1,fc2}``, ``norm1``, ``norm2``, ``norm``), so
``utils/weights.vit_from_jax`` maps it key for key.

Inputs: [B, 3, 128, 128] float32 RGB normalized by (x - 127.5) / 127.5.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.weights import vit_from_jax
from .layers import LayerNorm, init_uniform_fan_in_


class SelfAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.heads

        def split(t):            # [B, N, D] -> [B, H, N, hd]
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        att = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5, dim=-1)
        return (att @ v).transpose(1, 2).reshape(b, n, d)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, dim, heads, eps=1e-12):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = SelfAttention(dim, heads)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, dim * 4)

    def forward(self, x):
        x = x + self.proj(self.attn(self.norm1(x)))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Returns the LayerNorm'd class-token embedding: [B, dim]."""

    def __init__(self, img_size=128, patch_size=16, dim=768, depth=12, eps=1e-12):
        super().__init__()
        n = img_size // patch_size
        self.depth = depth
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n * n + 1, dim))
        self.patch_embedding = nn.Conv2d(3, dim, patch_size, patch_size)
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, dim // 64, eps))
        self.norm = LayerNorm(dim, eps)

    def forward(self, x, remat=False):
        """``remat``: recompute each block's activations in the backward
        pass (``torch.utils.checkpoint``) instead of keeping them."""
        x = self.patch_embedding(x).flatten(2).transpose(1, 2)    # [B, n*n, dim], row-major
        x = torch.cat([self.class_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embedding
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.norm(x[:, 0])

    @classmethod
    def from_jax(cls, params_np, **kw):
        """Build from the JAX package's parameter tree (numpy arrays); the
        width and depth (``dim``, ``depth``) must match it."""
        model = cls(**kw)
        model.load_state_dict(vit_from_jax(params_np), strict=True)
        return model

    @classmethod
    def seeded(cls, seed=0, **kw):
        """Random weights from an explicit ``torch.Generator``: conv and
        dense weights and biases uniform in +-1/sqrt(fan_in) (torch's
        default ranges); LayerNorm scale 1, bias 0; class token and
        positional embedding 0 (the JAX package's initializers)."""
        return init_uniform_fan_in_(cls(**kw), seed)


B16 = dict(img_size=128, patch_size=16, dim=768, depth=12)
L16 = dict(img_size=128, patch_size=16, dim=1024, depth=24)


def vit_b16():
    return ViT(**B16)


def vit_l16():
    return ViT(**L16)


def preprocess_uint8(images_u8_rgb):
    """(x - 127.5) / 127.5, the cv2.blobFromImages(1/127.5, 127.5) affine
    (encoders/vit.py:141): uint8 [..., 3] RGB -> float32."""
    return (images_u8_rgb.to(torch.float32) - 127.5) / 127.5


def torch_spec(depth=12):
    """Ordered checkpoint spec matching the reference ViT registration order
    (encoders/vit.py:80-94 after the AnimeVIT.wconv reordering): class token,
    positional embedding, patch conv, then per block norm1 / q / k / v / proj /
    norm2 / fc1 / fc2, then the final norm; the JAX layout's paths, which
    ``ViT.from_jax`` reads."""
    from ..utils import weights as W

    els = [W.param("class_token"), W.param("pos_embedding"),
           W.conv("patch_embedding", bias=True)]
    for i in range(depth):
        b = f"block{i}"
        els.append(W.ln(f"{b}/norm1"))
        for nm in ("q", "k", "v"):
            els.append(W.linear(f"{b}/attn/{nm}"))
        els.append(W.linear(f"{b}/proj"))
        els.append(W.ln(f"{b}/norm2"))
        els.append(W.linear(f"{b}/mlp/fc1"))
        els.append(W.linear(f"{b}/mlp/fc2"))
    els.append(W.ln("norm"))
    return els
