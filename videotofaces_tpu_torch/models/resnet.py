"""ResNet-50 backbone returning the C2..C5 feature maps (counterpart of
videotofaces_tpu/models/resnet.py), NCHW.

Architecture parity target: backbones/resnet.py:12-55 of the reference
(torchvision-style bottlenecks: 1x1 -> 3x3 (stride) -> 1x1 with the residual
add before the last ReLU; stride-2 1x1 downsample projections). Module names
follow the JAX parameter tree (``stem``, ``layer{1..4}_block{i}`` with
``u1``/``u2``/``u3``/``downsample``). Convolutions are cuDNN's on the card.
"""

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


def resnet50(bn_eps=1e-5):
    return ResNet((3, 4, 6, 3), bn_eps)


def torch_spec(block_counts=(3, 4, 6, 3), prefix=""):
    """Checkpoint spec in the reference registration order (stem, then each
    bottleneck's u1/u2/u3 followed by its downsample projection), with the
    JAX layout's paths."""
    from ..utils import weights as W

    els = W.convunit(f"{prefix}stem")
    for li, n in enumerate(block_counts):
        for bi in range(n):
            p = f"{prefix}layer{li + 1}_block{bi}"
            for u in ("u1", "u2", "u3"):
                els += W.convunit(f"{p}/{u}")
            if bi == 0:
                els += W.convunit(f"{p}/downsample")
    return els
