"""Model registry: CLI name -> ModelDef, lazily imported.

The port's counterpart of the JAX package's ``models/registry.py``. A
model here is an ``nn.Module``: ``build`` makes one with random weights
(from a ``torch.Generator``), ``convert_torch`` maps a reference ``.pth``
state dict onto the JAX package's tree layout, and ``load_tree`` builds the
module that tree fits (a transformer's depth read from the tree, by the
entry's ``depth``) and fills it through ``checkpoint/from_jax.load_jax_tree``
— the one path for weights. Names that the JAX package knows and the port
does not run yet raise ``NotImplementedError`` naming the ROADMAP queue
item.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from torch import nn

from ..checkpoint.from_jax import load_jax_tree
from ..device import resolve_device

_PKG = "garbage_classification_rca_tpu_torch.models"


def layers_depth(params: dict) -> int:
    """A transformer's depth: the length of its tree's ``layers`` list (a
    text classifier's under ``encoder``)."""
    return len(params.get("encoder", params)["layers"])


@dataclass(frozen=True)
class ModelDef:
    """Image models take a normalized NHWC tensor, text models
    ``(input_ids, attention_mask)`` int32 [B, L]; both return logits."""

    name: str
    # (num_classes, *, generator), and layers= where `depth` is set
    build: Callable[..., nn.Module]
    convert_torch: Callable[..., Tuple[dict, dict]]   # (sd, num_classes)
    extras: Dict[str, Any] = field(default_factory=dict)   # "bn_eps", "cfg"
    # the depth `build` takes, read from a JAX-layout tree; None for the
    # models of a fixed depth (the conv backbones)
    depth: Optional[Callable[[dict], int]] = layers_depth

    def load_tree(self, params: dict, state: Optional[dict] = None, *,
                  num_classes: int = 4, device="cuda") -> nn.Module:
        """The model holding the weights of JAX-layout trees, on `device`,
        in eval mode; a transformer's depth is the tree's."""
        dev = resolve_device(device)
        kw = {} if self.depth is None else {"layers": self.depth(params)}
        model = self.build(num_classes, **kw)
        load_jax_tree(model, params, state or None, allow_skipped=())
        return model.to(dev).eval()


_IMAGE_MODULES = {
    "transformer_B16": f"{_PKG}.image.vit",
    "transformer_L16": f"{_PKG}.image.vit",
    "eff_v2_small": f"{_PKG}.image.efficientnet_v2",
    "eff_v2_medium": f"{_PKG}.image.efficientnet_v2",
    "eff_v2_large": f"{_PKG}.image.efficientnet_v2",
    "b0": f"{_PKG}.image.efficientnet",
    "b4": f"{_PKG}.image.efficientnet",
    "b5": f"{_PKG}.image.efficientnet",
    "res18": f"{_PKG}.image.resnet",
    "res50": f"{_PKG}.image.resnet",
    "res152": f"{_PKG}.image.resnet",
    "convnext": f"{_PKG}.image.convnext",
    "mb": f"{_PKG}.image.mobilenet_v3",
    "shuffle_net": f"{_PKG}.image.shufflenet_v2",
}

_TEXT_MODULES = {
    "distilbert": f"{_PKG}.text.distilbert",
    "bert": f"{_PKG}.text.bert",
    "roberta": f"{_PKG}.text.roberta",
}

# names of the JAX package's registry that are still to port
_UNPORTED_TEXT = ("bart", "gpt2", "mobilebert", "mobile_bert")

IMAGE_MODELS = tuple(_IMAGE_MODULES)
TEXT_MODELS = tuple(_TEXT_MODULES) + _UNPORTED_TEXT


def _load(table, unported, item: str, name: str) -> ModelDef:
    if name in unported:
        raise NotImplementedError(
            f"model '{name}' is not ported to PyTorch yet (ROADMAP.md, "
            f"queue 1 item {item}); the JAX package runs it")
    if name not in table:
        raise KeyError(f"unknown model '{name}'; known: "
                       f"{sorted(tuple(table) + unported)}")
    return importlib.import_module(table[name]).model_def(name)


def get_image_model(name: str) -> ModelDef:
    return _load(_IMAGE_MODULES, (), "3", name)


def get_text_model(name: str) -> ModelDef:
    return _load(_TEXT_MODULES, _UNPORTED_TEXT, "2", name)
