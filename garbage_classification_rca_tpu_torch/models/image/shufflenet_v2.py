"""ShuffleNetV2 x2.0: torchvision ``shufflenet_v2_x2_0`` with ``fc``
replaced by ``Linear(2048, n)``, BASELINE.json's "shuffle_net image-only
eval".

The port of the JAX package's ``models/image/shufflenet_v2.py``: conv1
(3 -> 24, s2) -> max pool 3 s2 -> stages of 4 / 8 / 4 units (out 244 /
488 / 976) -> conv5 (1x1 -> 2048) -> global pool -> fc. A stage's first
unit downsamples and runs both branches on the whole input; the others
split the channels in half and run branch 2 on the second half. Each unit
ends in a channel shuffle with groups 2. Every conv is a ``ConvBN`` pair
(BN eps 1e-5), so ``nn/fold.fold_batchnorm`` folds the model.

The trunk runs NCHW in ``channels_last`` memory, the JAX package's NHWC
bytes: the split is a channel slice of that memory, and the concat and the
shuffle are one copy on the NHWC view (``concat_shuffle``). Train mode
runs every BatchNorm on the batch's statistics (momentum 0.1); there is no
random site.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef
from .efficientnet_common import ConvBN, convert_conv_bn as _c_cb

STAGE_OUT = (244, 488, 976)
REPEATS = (4, 8, 4)
CONV1_OUT = 24
CONV5_OUT = 2048
BN_EPS = 1e-5
BN_MOM = 0.1


def concat_shuffle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX ``channel_shuffle(concatenate([a, b], channels), groups=2)``
    of two NCHW tensors with C channels each, as one copy: output channel
    2i is a's channel i, 2i + 1 is b's. The result is channels_last."""
    n, c, h, w = a.shape
    y = torch.stack((a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)), dim=-1)
    return y.reshape(n, h, w, 2 * c).permute(0, 3, 1, 2)


class Unit(nn.Module):
    """A stage's unit; ``b1_*`` (branch 1) only in the downsampling one."""

    def __init__(self, c_in: int, c_out: int, first: bool, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        half = c_out // 2
        if first:
            self.b1_dw = ConvBN(3, c_in, c_in, groups=c_in, generator=g)
            self.b1_pw = ConvBN(1, c_in, half, generator=g)
        self.b2_pw1 = ConvBN(1, c_in if first else half, half, generator=g)
        self.b2_dw = ConvBN(3, half, half, groups=half, generator=g)
        self.b2_pw2 = ConvBN(1, half, half, generator=g)


class ShuffleNetV2(nn.Module):
    """Attribute names follow the JAX parameter tree."""

    def __init__(self, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv1 = ConvBN(3, 3, CONV1_OUT, generator=g)
        self.stages = nn.ModuleList()
        c_in = CONV1_OUT
        for c_out, n in zip(STAGE_OUT, REPEATS):
            self.stages.append(nn.ModuleList(
                Unit(c_in if j == 0 else c_out, c_out, j == 0, generator=g)
                for j in range(n)))
            c_in = c_out
        self.conv5 = ConvBN(1, c_in, CONV5_OUT, generator=g)
        self.fc = core.Linear(CONV5_OUT, num_classes, generator=g)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, train: bool = False, key=None):
        """Normalized NHWC images -> logits [B, n_classes]. ``train``: BN
        on batch statistics, its running stats updated in place; `key` is
        unused (the model has no dropout)."""
        relu = core.relu
        bn = dict(train=train, momentum=BN_MOM)
        h = relu(self.conv1(x.permute(0, 3, 1, 2), BN_EPS, stride=2, **bn))
        h = core.max_pool(h, 3, 2, padding=1)
        for stage in self.stages:
            for j, u in enumerate(stage):
                if j == 0:
                    b1 = u.b1_dw(h, BN_EPS, stride=2, groups=h.shape[1], **bn)
                    b1 = relu(u.b1_pw(b1, BN_EPS, **bn))
                    b2, stride = h, 2
                else:
                    b1, b2 = h.chunk(2, dim=1)
                    stride = 1
                y = relu(u.b2_pw1(b2, BN_EPS, **bn))
                y = u.b2_dw(y, BN_EPS, stride=stride, groups=y.shape[1], **bn)
                y = relu(u.b2_pw2(y, BN_EPS, **bn))
                h = concat_shuffle(b1, y)
        h = relu(self.conv5(h, BN_EPS, **bn))
        return self.fc(core.global_avg_pool(h))


def convert_torch(sd, num_classes: int = 4):
    """A torchvision ShuffleNetV2 state dict (numpy-valued) -> (params,
    state) in the JAX tree layout."""
    params = {"stages": []}
    state = {"stages": []}
    params["conv1"], state["conv1"] = _c_cb(sd, "conv1.0", "conv1.1")
    for si, n in enumerate(REPEATS):
        sp, ss = [], []
        for j in range(n):
            pre = f"stage{si + 2}.{j}."
            p, s = {}, {}
            if j == 0:
                p["b1_dw"], s["b1_dw"] = _c_cb(sd, pre + "branch1.0",
                                               pre + "branch1.1")
                p["b1_pw"], s["b1_pw"] = _c_cb(sd, pre + "branch1.2",
                                               pre + "branch1.3")
            p["b2_pw1"], s["b2_pw1"] = _c_cb(sd, pre + "branch2.0",
                                             pre + "branch2.1")
            p["b2_dw"], s["b2_dw"] = _c_cb(sd, pre + "branch2.3",
                                           pre + "branch2.4")
            p["b2_pw2"], s["b2_pw2"] = _c_cb(sd, pre + "branch2.5",
                                             pre + "branch2.6")
            sp.append(p)
            ss.append(s)
        params["stages"].append(sp)
        state["stages"].append(ss)
    params["conv5"], state["conv5"] = _c_cb(sd, "conv5.0", "conv5.1")
    w = sd["fc.weight"].T
    if w.shape[1] != num_classes:
        raise ValueError(
            f"fc has {w.shape[1]} classes, expected {num_classes}")
    params["fc"] = {"w": w, "b": sd["fc.bias"]}
    return params, state


def model_def(name: str) -> ModelDef:
    def build(num_classes: int = 4, *, generator=None):
        return ShuffleNetV2(num_classes, generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch,
                    extras={"bn_eps": BN_EPS}, depth=None)
