"""EfficientNetV2 S / M / L: the stand-alone classifiers (torchvision
``efficientnet_v2_{s,m,l}`` with ``classifier[1]`` replaced by
``Linear(1280, n)``) and the multi-stage feature extractor used by the
fusion models (M).

``extractor_features`` returns (out_stage3, out_stage6, pooled) with the
reference's indexing: its "stage3" is torchvision features[4] (our
stages[3]) and "stage6" features[7] (our stages[6]). Input sizes per name
are ``config.IMAGE_ARCHS``'s.
"""

from __future__ import annotations

from ..registry import ModelDef
from . import efficientnet_common as eff

CONFIGS = {
    "eff_v2_small": eff.EffNetConfig(
        stages=(("fused", 1, 3, 1, 24, 24, 2), ("fused", 4, 3, 2, 24, 48, 4),
                ("fused", 4, 3, 2, 48, 64, 4), ("mb", 4, 3, 2, 64, 128, 6),
                ("mb", 6, 3, 1, 128, 160, 9), ("mb", 6, 3, 2, 160, 256, 15)),
        stem_out=24, head_out=1280, bn_eps=1e-3, dropout=0.2),
    "eff_v2_medium": eff.EffNetConfig(
        stages=(("fused", 1, 3, 1, 24, 24, 3), ("fused", 4, 3, 2, 24, 48, 5),
                ("fused", 4, 3, 2, 48, 80, 5), ("mb", 4, 3, 2, 80, 160, 7),
                ("mb", 6, 3, 1, 160, 176, 14), ("mb", 6, 3, 2, 176, 304, 18),
                ("mb", 6, 3, 1, 304, 512, 5)),
        stem_out=24, head_out=1280, bn_eps=1e-3, dropout=0.3),
    "eff_v2_large": eff.EffNetConfig(
        stages=(("fused", 1, 3, 1, 32, 32, 4), ("fused", 4, 3, 2, 32, 64, 7),
                ("fused", 4, 3, 2, 64, 96, 7), ("mb", 4, 3, 2, 96, 192, 10),
                ("mb", 6, 3, 1, 192, 224, 19), ("mb", 6, 3, 2, 224, 384, 25),
                ("mb", 6, 3, 1, 384, 640, 7)),
        stem_out=32, head_out=1280, bn_eps=1e-3, dropout=0.4),
}


def extractor_features(model: eff.EffNet, x, cfg: eff.EffNetConfig, *,
                       train: bool = False, key=None):
    """NHWC x -> (out_stage3 NHWC, out_stage6 NHWC, pooled [B, 1280])."""
    stage_outs, pooled = eff.features_all_stages(model, x, cfg, train=train,
                                                 key=key)
    nhwc = lambda a: a.permute(0, 2, 3, 1)
    return nhwc(stage_outs[3]), nhwc(stage_outs[6]), pooled


def model_def(name: str) -> ModelDef:
    return eff.classifier_def(name, CONFIGS[name])
