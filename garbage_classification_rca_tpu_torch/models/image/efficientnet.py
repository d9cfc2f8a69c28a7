"""EfficientNet (v1) B0 / B4 / B5: torchvision ``efficientnet_b{0,4,5}``
with ``classifier[1]`` replaced by ``Linear(head, n)``.

The stage tables come from B0's by the compound-scaling rules
(``efficientnet_common.v1_stages``). BatchNorm: b0 / b4 keep torch's
defaults (eps 1e-5, momentum 0.1), b5 takes eps 1e-3 and momentum 0.01
(torchvision's norm_layer for b5..b7). Input sizes are non-square,
``config.IMAGE_ARCHS``'s (H, W): (224, 256), (380, 384), (456, 489).
"""

from __future__ import annotations

from ..registry import ModelDef
from . import efficientnet_common as eff


def _v1_config(width, depth, dropout, bn_eps=1e-5, bn_momentum=0.1):
    head = eff._make_divisible(1280 * width) if width > 1.0 else 1280
    return eff.EffNetConfig(
        stages=eff.v1_stages(width, depth),
        stem_out=eff._make_divisible(32 * width),
        head_out=head, bn_eps=bn_eps, bn_momentum=bn_momentum,
        dropout=dropout)


CONFIGS = {
    "b0": _v1_config(1.0, 1.0, 0.2),
    "b4": _v1_config(1.4, 1.8, 0.4),
    "b5": _v1_config(1.6, 2.2, 0.4, bn_eps=1e-3, bn_momentum=0.01),
}


def model_def(name: str) -> ModelDef:
    return eff.classifier_def(name, CONFIGS[name])
