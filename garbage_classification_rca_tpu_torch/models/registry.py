"""Model registry: CLI name -> ModelDef, lazily imported.

The port's counterpart of the JAX package's ``models/registry.py``. A
model here is an ``nn.Module``: ``build`` makes one with random weights
(from a ``torch.Generator``), ``convert_torch`` maps a reference ``.pth``
state dict onto the JAX package's tree layout, and ``load_tree`` builds the
module that tree fits (depth read from the tree) and fills it through
``checkpoint/from_jax.load_jax_tree`` — the one path for weights. Names
that the JAX package knows and the port does not run yet raise
``NotImplementedError`` naming the ROADMAP queue item.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from torch import nn

from ..checkpoint.from_jax import load_jax_tree
from ..device import resolve_device

_PKG = "garbage_classification_rca_tpu_torch.models"


@dataclass(frozen=True)
class ModelDef:
    """Image models take a normalized NHWC tensor, text models
    ``(input_ids, attention_mask)`` int32 [B, L]; both return logits."""

    name: str
    build: Callable[..., nn.Module]    # (num_classes, *, layers, generator)
    convert_torch: Callable[..., Tuple[dict, dict]]   # (sd, num_classes)
    extras: Dict[str, Any] = field(default_factory=dict)   # "bn_eps", "cfg"

    def load_tree(self, params: dict, state: Optional[dict] = None, *,
                  num_classes: int = 4, device="cuda") -> nn.Module:
        """The model holding the weights of JAX-layout trees, on `device`,
        in eval mode; its depth is the tree's."""
        dev = resolve_device(device)
        tree = params.get("encoder", params)
        model = self.build(num_classes, layers=len(tree["layers"]))
        load_jax_tree(model, params, state or None, allow_skipped=())
        return model.to(dev).eval()


_IMAGE_MODULES = {
    "transformer_B16": f"{_PKG}.image.vit",
    "transformer_L16": f"{_PKG}.image.vit",
}

_TEXT_MODULES = {
    "distilbert": f"{_PKG}.text.distilbert",
    "bert": f"{_PKG}.text.bert",
    "roberta": f"{_PKG}.text.roberta",
}

# names of the JAX package's registry that are still to port
_UNPORTED_IMAGE = ("eff_v2_small", "eff_v2_medium", "eff_v2_large", "b0",
                   "b4", "b5", "res18", "res50", "res152", "convnext", "mb",
                   "shuffle_net")
_UNPORTED_TEXT = ("bart", "gpt2", "mobilebert", "mobile_bert")

IMAGE_MODELS = tuple(_IMAGE_MODULES) + _UNPORTED_IMAGE
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
    return _load(_IMAGE_MODULES, _UNPORTED_IMAGE, "3", name)


def get_text_model(name: str) -> ModelDef:
    return _load(_TEXT_MODULES, _UNPORTED_TEXT, "2", name)
