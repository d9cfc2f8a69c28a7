"""Model registry: CLI name -> ModelDef, lazily imported.

The port's counterpart of the JAX package's ``models/registry.py``. A
model here is an ``nn.Module``: ``build`` makes one with random weights
(from a ``torch.Generator``), ``convert_torch`` maps a reference ``.pth``
state dict onto the JAX package's tree layout, and ``load_tree`` builds the
module that tree fits (a transformer's depth read from the tree, by the
entry's ``depth``, and any other build option by its ``options``) and
fills it through ``checkpoint/from_jax.load_jax_tree`` — the one path for
weights. The port knows every name of the JAX package's registry.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

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
    # further `build` keywords read from the names of the tree's top-level
    # entries (MobileBERT's optional pooler); None: there are none
    options: Optional[Callable[[Iterable[str]], dict]] = None

    def build_kwargs(self, names: Iterable[str]) -> dict:
        """`build`'s keywords besides `layers` for a tree, or a state
        dict, whose top-level entries are `names`."""
        return {} if self.options is None else self.options(set(names))

    def load_tree(self, params: dict, state: Optional[dict] = None, *,
                  num_classes: int = 4, device="cuda") -> nn.Module:
        """The model holding the weights of JAX-layout trees, on `device`,
        in eval mode; a transformer's depth is the tree's."""
        dev = resolve_device(device)
        kw = {} if self.depth is None else {"layers": self.depth(params)}
        kw.update(self.build_kwargs(params))
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
    "bart": f"{_PKG}.text.bart",
    "gpt2": f"{_PKG}.text.gpt2",
    "mobilebert": f"{_PKG}.text.mobilebert",
    # the reference CLI's spelling
    "mobile_bert": f"{_PKG}.text.mobilebert",
}

IMAGE_MODELS = tuple(_IMAGE_MODULES)
TEXT_MODELS = tuple(_TEXT_MODULES)


def _load(table, name: str) -> ModelDef:
    if name not in table:
        raise KeyError(f"unknown model '{name}'; known: {sorted(table)}")
    return importlib.import_module(table[name]).model_def(name)


def get_image_model(name: str) -> ModelDef:
    return _load(_IMAGE_MODULES, name)


def get_text_model(name: str) -> ModelDef:
    return _load(_TEXT_MODULES, name)
