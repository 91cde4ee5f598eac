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

from functools import partial

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

    def tp_forward(self, p, x, devices, remat=False):
        """The forward with tensor-parallel blocks (Megatron style), on
        weights held outside the module: ``p`` maps each of this module's
        state-dict names to its tensors, one per ``"model"`` device
        (``devices``, one row of a mesh) for the leaves split by
        ``parallel/sharding.py::vit_param_spec`` — q / k / v and fc1 by
        output columns, proj and fc2 by input rows — and one, on
        ``devices[0]``, for every other leaf. ``x`` lies on ``devices[0]``,
        where the replicated parts (patch embedding, class token, norms,
        residuals, the row-parallel biases) run once; a block's
        column-parallel products run on each device, and its row-parallel
        partial products are moved to ``devices[0]`` and summed there (the
        all-reduce), in device order. Where the split leaves whole heads on
        each device, each attends over its own; where it cuts a head, the
        q / k / v columns are gathered on ``devices[0]`` for the softmax
        and split again for ``proj``. A layer whose weights are one tensor
        (a width ``len(devices)`` does not divide) runs whole on
        ``devices[0]``. Same result as ``forward`` up to float rounding."""
        def one(name):
            return p[name][0]

        x = F.conv2d(x, one("patch_embedding.weight"), one("patch_embedding.bias"),
                     stride=self.patch_embedding.stride).flatten(2).transpose(1, 2)
        x = torch.cat([one("class_token").expand(x.shape[0], -1, -1), x], dim=1)
        x = x + one("pos_embedding")
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            fn = partial(_tp_block, p, f"block{i}.", devices, block.attn.heads, block.norm1.eps)
            x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        return F.layer_norm(x[:, 0], x.shape[-1:], one("norm.weight"), one("norm.bias"),
                            self.norm.eps)

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


def _row_parallel(parts, bias, dev0):
    """The sum of the partial products (in device order) on ``dev0``, plus
    the replicated bias."""
    out = parts[0].to(dev0)
    for t in parts[1:]:
        out = out + t.to(dev0)
    return out + bias


def _tp_attention(p, pre, h, devices, heads):
    w = [p[pre + "attn.%s.weight" % nm] for nm in "qkv"]
    b = [p[pre + "attn.%s.bias" % nm] for nm in "qkv"]
    proj_w, proj_b = p[pre + "proj.weight"], p[pre + "proj.bias"][0]
    n = len(w[0])
    if n == 1:
        return F.linear(attend(*(F.linear(h, w[i][0], b[i][0]) for i in range(3)), heads),
                        proj_w[0], proj_b)
    hs = [h.to(d) for d in devices]
    qkv = [[F.linear(hs[j], w[i][j], b[i][j]) for j in range(n)] for i in range(3)]
    cols, hd = h.shape[-1] // n, h.shape[-1] // heads
    if cols % hd == 0:                      # whole heads on each device
        a = [attend(qkv[0][j], qkv[1][j], qkv[2][j], cols // hd) for j in range(n)]
    else:                                   # a split cuts a head: attend on devices[0]
        full = [torch.cat([t.to(devices[0]) for t in ts], dim=-1) for ts in qkv]
        a = [t.to(devices[j]) for j, t in enumerate(attend(*full, heads).tensor_split(n, -1))]
    return _row_parallel([F.linear(a[j], proj_w[j]) for j in range(n)], proj_b, devices[0])


def _tp_mlp(p, pre, h, devices):
    w1, b1 = p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"]
    w2, b2 = p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"][0]
    n = len(w1)
    if n == 1:
        return F.linear(F.gelu(F.linear(h, w1[0], b1[0]), approximate="none"), w2[0], b2)
    parts = [F.linear(F.gelu(F.linear(h.to(d), w1[j], b1[j]), approximate="none"), w2[j])
             for j, d in enumerate(devices)]
    return _row_parallel(parts, b2, devices[0])


def _tp_block(p, pre, devices, heads, eps, x):
    """``Block.forward`` with its weights in ``p`` (see ``ViT.tp_forward``)."""
    d = x.shape[-1:]
    h = F.layer_norm(x, d, p[pre + "norm1.weight"][0], p[pre + "norm1.bias"][0], eps)
    x = x + _tp_attention(p, pre, h, devices, heads)
    h = F.layer_norm(x, d, p[pre + "norm2.weight"][0], p[pre + "norm2.bias"][0], eps)
    return x + _tp_mlp(p, pre, h, devices)


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
