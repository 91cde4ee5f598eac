"""FaceNet (InceptionResnetV1) encoder for live-action face embeddings
(counterpart of videotofaces_tpu/models/facenet.py).

Architecture parity target: encoders/facenet.py:15-155 of the reference —
stem of 6 conv units, 5x Block35(0.17) -> Mixed_6a -> 10x Block17(0.1) ->
Mixed_7a -> 5x Block8(0.2) -> Block8(1.0, no relu) -> global average pool ->
Linear(1792->512, no bias) -> BatchNorm(eps=1e-3) -> L2 normalize. Every
conv unit is conv + BN(1e-3) + ReLU with no conv bias.

Inputs: [B, 3, 160, 160] float32 RGB normalized by (x - 127.5) / 128 (the
cv2.blobFromImages affine at facenet.py:179). Module names follow the JAX
parameter tree ("stem0", "a0".."a4", "red_a", "b0".."b9", "red_b",
"c0".."c5", "head", "head_bn"), so ``utils/weights.facenet_from_jax`` maps
it key for key. Convolutions are cuDNN's on the card (XLA compiled them in
the JAX package; no Pallas kernel is involved).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.weights import facenet_from_jax
from .layers import BatchNorm, ConvUnit, init_uniform_fan_in_


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

    @classmethod
    def from_jax(cls, params_np):
        """Build from the JAX package's parameter tree (numpy arrays)."""
        model = cls()
        model.load_state_dict(facenet_from_jax(params_np), strict=True)
        return model

    @classmethod
    def seeded(cls, seed=0):
        """Random weights from an explicit ``torch.Generator``: conv and
        dense weights and biases uniform in +-1/sqrt(fan_in) (torch's
        default ranges); BatchNorm scale 1, bias 0, mean 0, var 1."""
        return init_uniform_fan_in_(cls(), seed)


def preprocess_uint8(images_u8_rgb):
    """(x - 127.5) / 128 (facenet.py:179 blobFromImages affine): uint8
    [..., 3] RGB -> float32."""
    return (images_u8_rgb.to(torch.float32) - 127.5) / 128.0


def torch_spec():
    """Ordered checkpoint spec matching the reference InceptionResnetV1
    registration order (encoders/facenet.py:126-154, classifier head dropped):
    stem conv units, 5x Block35, Mixed_6a, 10x Block17, Mixed_7a, 6x Block8,
    Linear(1792->512, no bias), BatchNorm1d; the JAX layout's paths, which
    ``InceptionResnetV1.from_jax`` reads."""
    from ..utils import weights as W

    els = []
    for i in range(6):
        els += W.convunit(f"stem{i}")
    for i in range(5):  # Block35: branch0, branch1 (2 units), branch2 (3), out conv
        p = f"a{i}"
        for unit in ("b0", "b1_0", "b1_1", "b2_0", "b2_1", "b2_2"):
            els += W.convunit(f"{p}/{unit}")
        els.append(W.conv(f"{p}/out", bias=True))
    for unit in ("b0", "b1_0", "b1_1", "b1_2"):  # Mixed_6a
        els += W.convunit(f"red_a/{unit}")
    for i in range(10):  # Block17
        p = f"b{i}"
        for unit in ("b0", "b1_0", "b1_1", "b1_2"):
            els += W.convunit(f"{p}/{unit}")
        els.append(W.conv(f"{p}/out", bias=True))
    for unit in ("b0_0", "b0_1", "b1_0", "b1_1", "b2_0", "b2_1", "b2_2"):  # Mixed_7a
        els += W.convunit(f"red_b/{unit}")
    for i in range(6):  # 5x Block8(relu) + final Block8(no relu)
        p = f"c{i}"
        for unit in ("b0", "b1_0", "b1_1", "b1_2"):
            els += W.convunit(f"{p}/{unit}")
        els.append(W.conv(f"{p}/out", bias=True))
    els.append(W.linear("head", bias=False))
    els.append(W.bn("head_bn"))
    return els
