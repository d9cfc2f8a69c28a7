"""EfficientNet engine — MBConv / FusedMBConv.

The port of the JAX package's ``models/image/efficientnet_common.py``:
  * public functions take and return NHWC tensors (the JAX layout);
    internally the trunk runs NCHW in ``channels_last`` memory, which is the
    same bytes, so cuDNN gets its preferred layout with no copy;
  * convolutions are plain cuDNN calls (plain XLA in the JAX package,
    outside any Pallas kernel);
  * BN eps per config (1e-3 for v2); the SE squeeze width is
    ``max(1, c_in // 4)`` on the PRE-expansion channels;
  * train mode: BatchNorm on batch statistics with running-stat updates
    (momentum per config), and stochastic depth at rate
    ``sd_prob * idx / total`` on each residual block, each block drawing
    from its own key ``key.fold_in(si * 1000 + j)`` (the JAX package's
    ``fold_in`` sites). BN folding (``nn/fold.py``) is for eval only.

Module names follow the JAX parameter tree (``stem``, ``stages[i][j]``
with ``expand``/``project``/``single``/``dw``/``se``, ``head``,
``classifier``), so ``checkpoint/from_jax.load_jax_tree`` fills a model
from it directly. ``EffNet`` is the trunk (the fusion models' image tower),
``EffNetClassifier`` the trunk with torchvision's classifier (the
stand-alone b0 / b4 / b5 and EfficientNetV2 S / M / L models).
``ConvBN`` is the conv + BatchNorm pair of every BN tower of the port
(ResNet, MobileNetV3 and ShuffleNetV2 build on it too).

``convert_torch`` maps the torchvision key layout
(``features.{i}.{j}.block.{k}.{0,1}.*`` / ``.fc1`` / ``.fc2``,
``classifier.1.*``) onto the JAX tree, for the classifiers and, from the
renamed keys of a fusion checkpoint, for the fusion models' trunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef

# stage row: (block_type, expand, kernel, stride, c_in, c_out, n_blocks)
Stage = Tuple[str, int, int, int, int, int, int]


@dataclass(frozen=True)
class EffNetConfig:
    stages: Tuple[Stage, ...]
    stem_out: int
    head_out: int
    bn_eps: float
    bn_momentum: float = 0.1
    dropout: float = 0.2      # the classifier's, train mode only
    sd_prob: float = 0.2


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def v1_stages(width: float, depth: float) -> Tuple[Stage, ...]:
    """EfficientNet-B0's stage table scaled by the compound rules: widths
    rounded to multiples of 8 (the 0.9 guard), depths rounded up."""
    base = [(1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2),
            (6, 3, 2, 40, 80, 3), (6, 5, 1, 80, 112, 3), (6, 5, 2, 112, 192, 4),
            (6, 3, 1, 192, 320, 1)]
    return tuple(("mb", e, k, s, _make_divisible(ci * width),
                  _make_divisible(co * width), math.ceil(n * depth))
                 for e, k, s, ci, co, n in base)


class ConvBN(nn.Module):
    """conv + BatchNorm (``bn`` is None once folded). The conv pads by
    (k - 1) // 2, as every conv + BN pair of the JAX towers does; no
    activation."""

    def __init__(self, k: int, c_in: int, c_out: int, *, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = core.Conv2d(k, k, c_in, c_out, groups=groups,
                                generator=generator)
        self.bn = core.BatchNorm(c_out)

    def forward(self, x, eps: float, *, stride=1, groups=1, train=False,
                momentum=0.1):
        k = self.conv.w.shape[-1]
        y = self.conv(x, stride=stride, padding=(k - 1) // 2, groups=groups)
        if self.bn is not None:
            y = self.bn(y, eps, train=train, momentum=momentum)
        return y


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, squeeze: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = core.Conv2d(1, 1, c, squeeze, bias=True,
                               generator=generator)
        self.fc2 = core.Conv2d(1, 1, squeeze, c, bias=True,
                               generator=generator)


class Block(nn.Module):
    def __init__(self, btype: str, expand: int, kernel: int, c_in: int,
                 c_out: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        exp = c_in * expand
        g = generator
        if btype == "fused":
            if expand != 1:
                self.expand = ConvBN(kernel, c_in, exp, generator=g)
                self.project = ConvBN(1, exp, c_out, generator=g)
            else:
                self.single = ConvBN(kernel, c_in, c_out, generator=g)
        else:
            if expand != 1:
                self.expand = ConvBN(1, c_in, exp, generator=g)
            self.dw = ConvBN(kernel, exp, exp, groups=exp, generator=g)
            self.se = SqueezeExcite(exp, max(1, c_in // 4), generator=g)
            self.project = ConvBN(1, exp, c_out, generator=g)


class EffNet(nn.Module):
    """The trunk: stem, stages, head conv (no classifier)."""

    def __init__(self, cfg: EffNetConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBN(3, 3, cfg.stem_out, generator=generator)
        self.stages = nn.ModuleList()
        for btype, expand, kernel, _, c_in, c_out, n in cfg.stages:
            self.stages.append(nn.ModuleList(
                Block(btype, expand, kernel, c_in if j == 0 else c_out,
                      c_out, generator=generator) for j in range(n)))
        self.head = ConvBN(1, cfg.stages[-1][5], cfg.head_out,
                           generator=generator)
        self.to(memory_format=torch.channels_last)


class EffNetClassifier(EffNet):
    """The trunk and torchvision's classifier, Linear(head_out, n) on the
    pooled feature; in train mode the pooled feature drops at
    ``cfg.dropout``, drawn from ``key.fold_in(999)`` as in the JAX
    ``apply``."""

    def __init__(self, cfg: EffNetConfig, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator=generator)
        self.classifier = core.Linear(cfg.head_out, num_classes,
                                      generator=generator)

    def forward(self, x, *, train: bool = False,
                key: Optional[core.Key] = None):
        """Normalized NHWC images -> logits [B, n_classes]. ``train``: BN
        on batch statistics (running stats updated in place) and, with a
        `key`, stochastic depth and the classifier's dropout."""
        pooled = features_all_stages(self, x, self.cfg, train=train,
                                     key=key)[1]
        if train and key is not None:
            pooled = core.dropout(pooled, self.cfg.dropout,
                                  key.fold_in(999).generator(pooled.device))
        return self.classifier(pooled)


# ---------------------------------------------------------------------------
# forward (functions over the modules, as the JAX code reads its tree)
# ---------------------------------------------------------------------------


def _cna(m: ConvBN, x, *, act=True, **kw):
    y = m(x, **kw)
    return core.silu(y) if act else y


def _se(m: SqueezeExcite, x, act=core.silu, gate=torch.sigmoid):
    """x * gate(fc2(act(fc1(mean over H, W in fp32))))."""
    s = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
    s = act(m.fc1(s))
    s = gate(m.fc2(s))
    return x * s


def _block(m: Block, x, row: Stage, first: bool, *, eps, train=False,
           momentum=0.1, sd_rate=0.0, generator=None):
    btype, expand, _, stride, _, c_out, _ = row
    stride = stride if first else 1
    use_res = stride == 1 and x.shape[1] == c_out
    bn = dict(eps=eps, train=train, momentum=momentum)
    h = x
    if btype == "fused":
        if expand != 1:
            h = _cna(m.expand, h, stride=stride, **bn)
            h = _cna(m.project, h, act=False, **bn)
        else:
            h = _cna(m.single, h, stride=stride, **bn)
    else:
        if hasattr(m, "expand"):
            h = _cna(m.expand, h, **bn)
        h = _cna(m.dw, h, stride=stride, groups=h.shape[1], **bn)
        h = _se(m.se, h)
        h = _cna(m.project, h, act=False, **bn)
    if not use_res:
        return h
    if train:
        h = core.stochastic_depth(h, sd_rate, generator)
    return h + x


def features_all_stages(model: EffNet, x_nhwc: torch.Tensor,
                        cfg: EffNetConfig, *, train: bool = False,
                        key: Optional[core.Key] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run the trunk on NHWC input; returns (per-stage outputs as NCHW
    channels_last tensors, pooled [B, head_out]). ``train`` uses batch
    statistics (updating the BN buffers in place) and, with a ``key``,
    stochastic depth."""
    bn = dict(eps=cfg.bn_eps, train=train, momentum=cfg.bn_momentum)
    total = sum(r[-1] for r in cfg.stages)
    h = _cna(model.stem, x_nhwc.permute(0, 3, 1, 2), stride=2, **bn)
    stage_outs = []
    idx = 0
    for si, row in enumerate(cfg.stages):
        for j, bm in enumerate(model.stages[si]):
            gen = None
            if train and key is not None:
                gen = key.fold_in(si * 1000 + j).generator(h.device)
            h = _block(bm, h, row, j == 0, sd_rate=cfg.sd_prob * idx / total,
                       generator=gen, **bn)
            idx += 1
        stage_outs.append(h)
    h = _cna(model.head, h, **bn)
    return stage_outs, core.global_avg_pool(h)


# ---------------------------------------------------------------------------
# torchvision state-dict conversion
# ---------------------------------------------------------------------------


def convert_conv_bn(sd, conv_key: str, bn_key: str):
    """A torchvision Conv2d + BatchNorm2d pair (numpy-valued keys) -> the
    JAX (params, state) of a ``ConvBN``."""
    p = {"conv": {"w": sd[conv_key + ".weight"].transpose(2, 3, 1, 0)},
         "bn": {"scale": sd[bn_key + ".weight"], "bias": sd[bn_key + ".bias"]}}
    s = {"bn": {"mean": sd[bn_key + ".running_mean"],
                "var": sd[bn_key + ".running_var"]}}
    return p, s


def _c_cna(sd, pre):
    return convert_conv_bn(sd, pre + ".0", pre + ".1")


def convert_torch(sd, cfg: EffNetConfig, num_classes: int = 4):
    """torchvision ``features.{i}`` (and ``classifier.1``, where the dict
    has it) keys, numpy-valued -> the JAX (params, state) trees."""
    params = {"stages": []}
    state = {"stages": []}
    params["stem"], state["stem"] = _c_cna(sd, "features.0")
    for si, (btype, expand, _, _, _, _, n) in enumerate(cfg.stages):
        sp, ss = [], []
        for j in range(n):
            pre = f"features.{si + 1}.{j}.block"
            p, s = {}, {}
            if btype == "fused":
                if expand != 1:
                    p["expand"], s["expand"] = _c_cna(sd, pre + ".0")
                    p["project"], s["project"] = _c_cna(sd, pre + ".1")
                else:
                    p["single"], s["single"] = _c_cna(sd, pre + ".0")
            else:
                i = 0
                if expand != 1:
                    p["expand"], s["expand"] = _c_cna(sd, pre + f".{i}")
                    i += 1
                p["dw"], s["dw"] = _c_cna(sd, pre + f".{i}")
                i += 1
                p["se"] = {fc: {
                    "w": sd[pre + f".{i}.{fc}.weight"].transpose(2, 3, 1, 0),
                    "b": sd[pre + f".{i}.{fc}.bias"]} for fc in ("fc1", "fc2")}
                i += 1
                p["project"], s["project"] = _c_cna(sd, pre + f".{i}")
            sp.append(p)
            ss.append(s)
        params["stages"].append(sp)
        state["stages"].append(ss)
    params["head"], state["head"] = _c_cna(
        sd, f"features.{len(cfg.stages) + 1}")
    if "classifier.1.weight" in sd:
        w = sd["classifier.1.weight"].T
        if w.shape[1] != num_classes:
            raise ValueError(
                f"classifier has {w.shape[1]} classes, expected {num_classes}")
        params["classifier"] = {"w": w, "b": sd["classifier.1.bias"]}
    return params, state


def classifier_def(name: str, cfg: EffNetConfig) -> ModelDef:
    """The registry entry of a stand-alone EfficientNet classifier."""

    def build(num_classes: int = 4, *, generator=None):
        return EffNetClassifier(cfg, num_classes, generator=generator)

    return ModelDef(name=name, build=build,
                    convert_torch=lambda sd, num_classes=4: convert_torch(
                        sd, cfg, num_classes),
                    extras={"cfg": cfg, "bn_eps": cfg.bn_eps}, depth=None)
