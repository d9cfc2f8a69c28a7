"""MobileNetV3-Large: torchvision ``mobilenet_v3_large`` with
``classifier[3]`` replaced by ``Linear(1280, n)``.

The port of the JAX package's ``models/image/mobilenet_v3.py``: BN eps
1e-3; inverted residual blocks (``ROWS``) with ReLU or hardswish, an
optional squeeze-excite (ReLU inside, hardsigmoid gate, squeeze
``_make_divisible(exp / 4, 8)``), the residual only where stride 1 keeps
the channels; the last 1x1 conv to 960; the classifier Linear(960, 1280) ->
hardswish -> dropout -> Linear(1280, n). Every conv is a ``ConvBN`` pair;
the trunk runs NCHW in ``channels_last`` memory. Train mode runs every
BatchNorm on the batch's statistics (momentum 0.01) and the classifier's
dropout at 0.2, drawn from the step's key itself, as the JAX ``apply``
draws it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef
from .efficientnet_common import (ConvBN, SqueezeExcite, _c_cna,
                                  _make_divisible, _se)


class Row(NamedTuple):
    kernel: int
    exp: int
    out: int
    se: bool
    hs: bool       # hardswish (else relu)
    stride: int


# torchvision mobilenet_v3_large inverted-residual settings
ROWS: Tuple[Row, ...] = (
    Row(3, 16, 16, False, False, 1),
    Row(3, 64, 24, False, False, 2),
    Row(3, 72, 24, False, False, 1),
    Row(5, 72, 40, True, False, 2),
    Row(5, 120, 40, True, False, 1),
    Row(5, 120, 40, True, False, 1),
    Row(3, 240, 80, False, True, 2),
    Row(3, 200, 80, False, True, 1),
    Row(3, 184, 80, False, True, 1),
    Row(3, 184, 80, False, True, 1),
    Row(3, 480, 112, True, True, 1),
    Row(3, 672, 112, True, True, 1),
    Row(5, 672, 160, True, True, 2),
    Row(5, 960, 160, True, True, 1),
    Row(5, 960, 160, True, True, 1),
)

STEM_OUT = 16
LAST_CONV = 960
HEAD_HIDDEN = 1280
BN_EPS = 1e-3
BN_MOM = 0.01
DROPOUT = 0.2


class InvertedResidual(nn.Module):
    def __init__(self, r: Row, c_in: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.expand = (ConvBN(1, c_in, r.exp, generator=g)
                       if r.exp != c_in else None)
        self.dw = ConvBN(r.kernel, r.exp, r.exp, groups=r.exp, generator=g)
        self.se = (SqueezeExcite(r.exp, _make_divisible(r.exp // 4),
                                 generator=g) if r.se else None)
        self.project = ConvBN(1, r.exp, r.out, generator=g)


class MobileNetV3(nn.Module):
    """Attribute names follow the JAX parameter tree."""

    def __init__(self, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stem = ConvBN(3, 3, STEM_OUT, generator=g)
        self.blocks = nn.ModuleList()
        c_in = STEM_OUT
        for r in ROWS:
            self.blocks.append(InvertedResidual(r, c_in, generator=g))
            c_in = r.out
        self.last = ConvBN(1, c_in, LAST_CONV, generator=g)
        self.fc1 = core.Linear(LAST_CONV, HEAD_HIDDEN, generator=g)
        self.fc2 = core.Linear(HEAD_HIDDEN, num_classes, generator=g)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, train: bool = False,
                key: Optional[core.Key] = None):
        """Normalized NHWC images -> logits [B, n_classes]. ``train``: BN
        on batch statistics, its running stats updated in place, and with
        a `key` the classifier's dropout."""
        bn = dict(train=train, momentum=BN_MOM)
        h = core.hardswish(self.stem(x.permute(0, 3, 1, 2), BN_EPS,
                                     stride=2, **bn))
        for r, m in zip(ROWS, self.blocks):
            act = core.hardswish if r.hs else core.relu
            y = h
            if m.expand is not None:
                y = act(m.expand(y, BN_EPS, **bn))
            y = act(m.dw(y, BN_EPS, stride=r.stride, groups=r.exp, **bn))
            if m.se is not None:
                y = _se(m.se, y, core.relu, core.hardsigmoid)
            y = m.project(y, BN_EPS, **bn)
            h = y + h if r.stride == 1 and h.shape[1] == r.out else y
        h = core.hardswish(self.last(h, BN_EPS, **bn))
        z = core.hardswish(self.fc1(core.global_avg_pool(h)))
        if train and key is not None:
            z = core.dropout(z, DROPOUT, key.generator(z.device))
        return self.fc2(z)


def convert_torch(sd, num_classes: int = 4):
    """A torchvision MobileNetV3-Large state dict (numpy-valued) ->
    (params, state) in the JAX tree layout."""
    params = {"blocks": []}
    state = {"blocks": []}
    params["stem"], state["stem"] = _c_cna(sd, "features.0")
    c_in = STEM_OUT
    for i, r in enumerate(ROWS):
        pre = f"features.{i + 1}.block"
        p, s = {}, {}
        k = 0
        if r.exp != c_in:
            p["expand"], s["expand"] = _c_cna(sd, pre + f".{k}")
            k += 1
        p["dw"], s["dw"] = _c_cna(sd, pre + f".{k}")
        k += 1
        if r.se:
            p["se"] = {fc: {
                "w": sd[pre + f".{k}.{fc}.weight"].transpose(2, 3, 1, 0),
                "b": sd[pre + f".{k}.{fc}.bias"]} for fc in ("fc1", "fc2")}
            k += 1
        p["project"], s["project"] = _c_cna(sd, pre + f".{k}")
        params["blocks"].append(p)
        state["blocks"].append(s)
        c_in = r.out
    params["last"], state["last"] = _c_cna(sd, f"features.{len(ROWS) + 1}")
    params["fc1"] = {"w": sd["classifier.0.weight"].T,
                     "b": sd["classifier.0.bias"]}
    w = sd["classifier.3.weight"].T
    if w.shape[1] != num_classes:
        raise ValueError(
            f"classifier has {w.shape[1]} classes, expected {num_classes}")
    params["fc2"] = {"w": w, "b": sd["classifier.3.bias"]}
    return params, state


def model_def(name: str) -> ModelDef:
    def build(num_classes: int = 4, *, generator=None):
        return MobileNetV3(num_classes, generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch,
                    extras={"bn_eps": BN_EPS}, depth=None)
