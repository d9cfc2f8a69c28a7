"""ResNet-18 / 50 / 152: torchvision resnets with ``fc`` replaced by
``Linear(feat, n)``.

The port of the JAX package's ``models/image/resnet.py``: the 7x7 s2 stem,
max pool 3 s2 (padding 1), four stages of BasicBlocks (res18) or
Bottlenecks (res50 / res152, the stride on the 3x3 conv: torchvision's
v1.5), a 1x1 ``down`` projection at a stage's first block where the shape
changes, global pool, fc. Every conv is a ``ConvBN`` pair (BN eps 1e-5).
The trunk runs NCHW in ``channels_last`` memory. Train mode runs every
BatchNorm on the batch's statistics (momentum 0.1); there is no random
site.

``convert_torch`` maps torchvision's keys (conv1 / bn1,
``layer{1..4}.{j}.conv{1..3}`` + ``bn{1..3}``, ``downsample.0`` / ``.1``,
fc) onto the JAX tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef
from .efficientnet_common import ConvBN, convert_conv_bn

BN_EPS = 1e-5
BN_MOM = 0.1


@dataclass(frozen=True)
class ResNetConfig:
    block: str                 # 'basic' | 'bottleneck'
    layers: Tuple[int, int, int, int]
    width: int = 64


CONFIGS = {
    "res18": ResNetConfig("basic", (2, 2, 2, 2)),
    "res50": ResNetConfig("bottleneck", (3, 4, 6, 3)),
    "res152": ResNetConfig("bottleneck", (3, 8, 36, 3)),
}

EXPANSION = {"basic": 1, "bottleneck": 4}


class Block(nn.Module):
    """c1, c2 (BasicBlock) or c1, c2, c3 (Bottleneck), and ``down``."""

    def __init__(self, block: str, c_in: int, c_mid: int, c_out: int,
                 down: bool, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        if block == "basic":
            self.c1 = ConvBN(3, c_in, c_out, generator=g)
            self.c2 = ConvBN(3, c_out, c_out, generator=g)
            self.c3 = None
        else:
            self.c1 = ConvBN(1, c_in, c_mid, generator=g)
            self.c2 = ConvBN(3, c_mid, c_mid, generator=g)
            self.c3 = ConvBN(1, c_mid, c_out, generator=g)
        self.down = ConvBN(1, c_in, c_out, generator=g) if down else None


class ResNet(nn.Module):
    """Attribute names follow the JAX parameter tree (``layers`` are the
    four stages)."""

    def __init__(self, cfg: ResNetConfig, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.cfg = cfg
        exp = EXPANSION[cfg.block]
        self.stem = ConvBN(7, 3, 64, generator=g)
        self.layers = nn.ModuleList()
        c_in = 64
        for si, n in enumerate(cfg.layers):
            c_mid = cfg.width * 2 ** si
            c_out = c_mid * exp
            self.layers.append(nn.ModuleList(
                Block(cfg.block, c_in if j == 0 else c_out, c_mid, c_out,
                      j == 0 and (si > 0 or exp != 1), generator=g)
                for j in range(n)))
            c_in = c_out
        self.fc = core.Linear(c_in, num_classes, generator=g)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, train: bool = False, key=None):
        """Normalized NHWC images -> logits [B, n_classes]. ``train``: BN
        on batch statistics, its running stats updated in place; `key` is
        unused (the model has no dropout)."""
        relu = core.relu
        bn = dict(train=train, momentum=BN_MOM)
        h = relu(self.stem(x.permute(0, 3, 1, 2), BN_EPS, stride=2, **bn))
        h = core.max_pool(h, 3, 2, padding=1)
        for si, stage in enumerate(self.layers):
            for j, m in enumerate(stage):
                stride = 2 if (si > 0 and j == 0) else 1
                if m.c3 is None:
                    y = relu(m.c1(h, BN_EPS, stride=stride, **bn))
                    y = m.c2(y, BN_EPS, **bn)
                else:
                    y = relu(m.c1(h, BN_EPS, **bn))
                    y = relu(m.c2(y, BN_EPS, stride=stride, **bn))
                    y = m.c3(y, BN_EPS, **bn)
                identity = h if m.down is None else m.down(
                    h, BN_EPS, stride=stride, **bn)
                h = relu(y + identity)
        return self.fc(core.global_avg_pool(h))


def convert_torch(sd, cfg: ResNetConfig, num_classes: int = 4):
    """A torchvision ResNet state dict (numpy-valued) -> (params, state) in
    the JAX tree layout."""
    params = {"layers": []}
    state = {"layers": []}
    params["stem"], state["stem"] = convert_conv_bn(sd, "conv1", "bn1")
    n_convs = 2 if cfg.block == "basic" else 3
    for si, n in enumerate(cfg.layers):
        sp, ss = [], []
        for j in range(n):
            pre = f"layer{si + 1}.{j}."
            p, s = {}, {}
            for ci in range(1, n_convs + 1):
                p[f"c{ci}"], s[f"c{ci}"] = convert_conv_bn(
                    sd, pre + f"conv{ci}", pre + f"bn{ci}")
            if pre + "downsample.0.weight" in sd:
                p["down"], s["down"] = convert_conv_bn(
                    sd, pre + "downsample.0", pre + "downsample.1")
            sp.append(p)
            ss.append(s)
        params["layers"].append(sp)
        state["layers"].append(ss)
    w = sd["fc.weight"].T
    if w.shape[1] != num_classes:
        raise ValueError(
            f"fc has {w.shape[1]} classes, expected {num_classes}")
    params["fc"] = {"w": w, "b": sd["fc.bias"]}
    return params, state


def model_def(name: str) -> ModelDef:
    cfg = CONFIGS[name]

    def build(num_classes: int = 4, *, generator=None):
        return ResNet(cfg, num_classes, generator=generator)

    return ModelDef(name=name, build=build,
                    convert_torch=lambda sd, num_classes=4: convert_torch(
                        sd, cfg, num_classes),
                    extras={"cfg": cfg, "bn_eps": BN_EPS}, depth=None)
