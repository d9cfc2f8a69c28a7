"""ConvNeXt-Base: torchvision ``convnext_base`` with ``classifier[2]``
replaced by ``Linear(1024, n)``.

The port of the JAX package's ``models/image/convnext.py``: a 4x4 s4
patchify conv + LayerNorm; stages of CNBlocks (7x7 depthwise conv with
bias -> LayerNorm eps 1e-6 -> Linear C -> 4C -> exact GELU -> Linear 4C ->
C -> times the layer scale ``scale`` -> residual); LayerNorm + 2x2 s2 conv
between stages; the head pools, normalizes and applies the Linear. Widths
(128, 256, 512, 1024), depths (3, 3, 27, 3). No BatchNorm: nothing to
fold. Train mode adds stochastic depth (per sample) on block ``idx`` of
the ``total`` at rate ``SD_PROB * idx / (total - 1)``, drawn from
``key.fold_in(idx)``, as the JAX ``apply`` draws it.

The model runs channels-last as the JAX one does: its activations are
contiguous NHWC tensors, every LayerNorm and Linear acts on their last
axis (C), and a conv runs on the NCHW view of the same memory
(``channels_last``), so no layout copy is made around it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn import core
from ..registry import ModelDef

WIDTHS = (128, 256, 512, 1024)
DEPTHS = (3, 3, 27, 3)
LN_EPS = 1e-6
SD_PROB = 0.5


class CNBlock(nn.Module):
    def __init__(self, c: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dw = core.Conv2d(7, 7, c, c, groups=c, bias=True, generator=g)
        self.ln = core.LayerNorm(c, LN_EPS)
        self.fc1 = core.Linear(c, 4 * c, generator=g)
        self.fc2 = core.Linear(4 * c, c, generator=g)
        self.scale = nn.Parameter(torch.full((c,), 1e-6))


class Downsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln = core.LayerNorm(c_in, LN_EPS)
        self.conv = core.Conv2d(2, 2, c_in, c_out, bias=True,
                                generator=generator)


def _conv_nhwc(conv: core.Conv2d, h: torch.Tensor, **kw) -> torch.Tensor:
    """A conv of an NHWC tensor, through its NCHW (channels_last) view."""
    return conv(h.permute(0, 3, 1, 2), **kw).permute(0, 2, 3, 1)


class ConvNeXt(nn.Module):
    """Attribute names follow the JAX parameter tree."""

    def __init__(self, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stem_conv = core.Conv2d(4, 4, 3, WIDTHS[0], bias=True,
                                     generator=g)
        self.stem_ln = core.LayerNorm(WIDTHS[0], LN_EPS)
        self.stages = nn.ModuleList(
            nn.ModuleList(CNBlock(w, generator=g) for _ in range(d))
            for w, d in zip(WIDTHS, DEPTHS))
        self.downsamples = nn.ModuleList(
            Downsample(WIDTHS[si], WIDTHS[si + 1], generator=g)
            for si in range(3))
        self.ln_head = core.LayerNorm(WIDTHS[-1], LN_EPS)
        self.fc = core.Linear(WIDTHS[-1], num_classes, generator=g)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, train: bool = False,
                key: Optional[core.Key] = None):
        """Normalized NHWC images -> logits [B, n_classes]; ``train`` with
        a `key`: stochastic depth on the blocks' residual branches."""
        h = self.stem_ln(_conv_nhwc(self.stem_conv, x, stride=4))
        total = sum(DEPTHS)
        idx = 0
        for si, stage in enumerate(self.stages):
            for p in stage:
                y = _conv_nhwc(p.dw, h, padding=3, groups=h.shape[-1])
                y = p.fc2(core.gelu(p.fc1(p.ln(y))))
                y = y * p.scale.to(y.dtype)
                if train and key is not None:
                    y = core.stochastic_depth(
                        y, SD_PROB * idx / (total - 1),
                        key.fold_in(idx).generator(y.device))
                h = h + y
                idx += 1
            if si < 3:
                d = self.downsamples[si]
                h = _conv_nhwc(d.conv, d.ln(h), stride=2)
        pooled = core.global_avg_pool(h.permute(0, 3, 1, 2))
        return self.fc(self.ln_head(pooled))


def convert_torch(sd, num_classes: int = 4):
    """A torchvision ConvNeXt state dict (numpy-valued) -> (params, {}) in
    the JAX tree layout: ``features.0`` the stem (conv, LayerNorm2d), odd
    ``features`` the stages, even ones the downsamples (LayerNorm2d,
    conv); ``classifier.0`` the head's LayerNorm2d, ``classifier.2`` its
    Linear. torchvision normalizes the pooled [B, C, 1, 1] map over C: the
    same as normalizing the pooled vector."""
    ln = lambda pre: {"scale": sd[pre + "weight"], "bias": sd[pre + "bias"]}
    conv = lambda pre: {"w": sd[pre + "weight"].transpose(2, 3, 1, 0),
                        "b": sd[pre + "bias"]}
    lin = lambda pre: {"w": sd[pre + "weight"].T, "b": sd[pre + "bias"]}
    params = {"stem_conv": conv("features.0.0."),
              "stem_ln": ln("features.0.1."), "stages": [], "downsamples": []}
    for si in range(4):
        fi = 1 + 2 * si
        params["stages"].append([{
            "dw": conv(f"features.{fi}.{j}.block.0."),
            "ln": ln(f"features.{fi}.{j}.block.2."),
            "fc1": lin(f"features.{fi}.{j}.block.3."),
            "fc2": lin(f"features.{fi}.{j}.block.5."),
            "scale": sd[f"features.{fi}.{j}.layer_scale"].reshape(-1),
        } for j in range(DEPTHS[si])])
        if si < 3:
            pre = f"features.{fi + 1}."
            params["downsamples"].append({"ln": ln(pre + "0."),
                                          "conv": conv(pre + "1.")})
    params["ln_head"] = ln("classifier.0.")
    params["fc"] = lin("classifier.2.")
    if params["fc"]["w"].shape[1] != num_classes:
        raise ValueError(f"classifier has {params['fc']['w'].shape[1]} "
                         f"classes, expected {num_classes}")
    return params, {}


def model_def(name: str) -> ModelDef:
    def build(num_classes: int = 4, *, generator=None):
        return ConvNeXt(num_classes, generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch,
                    depth=None)
