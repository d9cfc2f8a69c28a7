"""Load a parameter tree in the JAX package's layout into a port model.

The single path for weights, for every model of the port (the fusion
model, the text classifiers, ViT, BLIP-2 with its adapters and the
Q-Former classifier: ``load_blip2_tree``): the tests hand over a JAX model's
``(params, state)`` converted to numpy, and the port's ``convert_torch``
functions build the same numpy tree from a reference ``.pth`` first.

The walk follows the tree: a dict key names a child module, parameter or
buffer of the same name; a list indexes a ``ModuleList``. Leaves are
converted by the kind of module that owns them: a ``Linear`` weight goes
from ``[in, out]`` to ``[out, in]``, a ``Conv2d`` weight from HWIO to OIHW,
a ``GRU``'s ``w_ih`` / ``w_hh`` from ``[in, 3H]`` to ``[3H, in]``;
everything else is copied as is. Shapes must match, and every parameter
and buffer of the model must be filled.

``export_jax_tree`` goes the other way: every parameter and buffer of a
model as ``{dotted tree path: numpy array in the JAX layout}``, so that a
trained model can be compared with the JAX package's trees leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn import core


def _convert(owner: nn.Module, name: str, a: np.ndarray) -> np.ndarray:
    if name == "w" and isinstance(owner, core.Linear):
        return a.T
    if name == "w" and isinstance(owner, core.Conv2d):
        return a.transpose(3, 2, 0, 1)
    if name in ("w_ih", "w_hh") and isinstance(owner, core.GRU):
        return a.T
    return a


def _walk(module: nn.Module, tree, path: str, filled: set,
          skipped: List[str]) -> None:
    if isinstance(tree, (list, tuple)):
        if not isinstance(module, nn.ModuleList) or len(module) != len(tree):
            raise ValueError(f"{path}: list of {len(tree)} entries does not "
                             f"match {type(module).__name__}")
        for j, (m, sub) in enumerate(zip(module, tree)):
            _walk(m, sub, f"{path}.{j}", filled, skipped)
        return
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: leaf where a subtree was expected")
    for key, sub in tree.items():
        where = f"{path}.{key}" if path else key
        child = getattr(module, key, None)
        if isinstance(child, nn.Module):
            _walk(child, sub, where, filled, skipped)
        elif isinstance(child, torch.Tensor):
            a = _convert(module, key, np.asarray(sub))
            if tuple(a.shape) != tuple(child.shape):
                raise ValueError(f"{where}: shape {tuple(a.shape)} (after "
                                 f"layout conversion), model has "
                                 f"{tuple(child.shape)}")
            # a writable array is read in place (a converter's transpose
            # of a transpose is the checkpoint's own array); a read-only one
            # (a JAX array's view) is copied first
            with torch.no_grad():
                child.copy_(torch.from_numpy(
                    a if a.flags.writeable else np.array(a)))
            filled.add(id(child))
        else:
            skipped.append(where)


def load_jax_tree(model: nn.Module, params, state=None, *,
                  allow_skipped: Optional[Iterable[str]] = None
                  ) -> Tuple[nn.Module, List[str]]:
    """Fill `model` from numpy trees in the JAX layout, in place.

    Returns (model, skipped): the tree paths the model has no slot for
    (e.g. heads of fusion strategies the port does not run). Raises when a
    skipped path is not under one of `allow_skipped` (default: any path may
    be skipped), on any shape mismatch, and when a parameter or buffer of
    the model was not filled."""
    filled: set = set()
    skipped: List[str] = []
    _walk(model, params, "", filled, skipped)
    if state is not None:
        _walk(model, state, "", filled, skipped)
    if allow_skipped is not None:
        allow = tuple(allow_skipped)
        bad = [s for s in skipped
               if not any(s == a or s.startswith(a + ".") for a in allow)]
        if bad:
            raise ValueError(f"tree entries with no slot in the model: {bad}")
    missing = [n for n, t in list(model.named_parameters())
               + list(model.named_buffers()) if id(t) not in filled]
    if missing:
        raise ValueError(f"{len(missing)} model tensors not in the tree "
                         f"(first 8: {missing[:8]})")
    return model, skipped


def export_jax_tree(model: nn.Module) -> Dict[str, np.ndarray]:
    """{dotted path (``image.stages.0.1.dw.conv.w``): numpy array} for every
    parameter and buffer, in the JAX layouts (the inverse of the leaf
    conversion above); bf16 tensors come out as fp32 arrays."""
    out = {}
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        a = t.detach().cpu().float().numpy()
        if leaf == "w" and isinstance(owner, core.Linear):
            a = a.T
        elif leaf == "w" and isinstance(owner, core.Conv2d):
            a = a.transpose(2, 3, 1, 0)
        elif leaf in ("w_ih", "w_hh") and isinstance(owner, core.GRU):
            a = a.T
        out[name] = a
    return out


def load_blip2_tree(model: nn.Module, params, lora=None, trainable=None
                    ) -> nn.Module:
    """Fill a ``models.vlm.blip2.Blip2Model`` from the JAX package's BLIP-2
    trees, as numpy arrays: ``params`` (vision, qformer, projection, opt),
    the str-keyed ``lora`` adapters ({"0": {"q": {"a", "b"}, "k": ...},
    ...}) and the Q-Former ``trainable`` tree ({"classifier": {"w",
    "b"}}). Each part given fills its module whole and uses every leaf;
    a part not given is left as it is; a part for a slot the model lacks
    raises. An OPT tree that the JAX ``quantize_opt_weights`` made (int8
    ``w`` with ``w_scale`` in every layer's q, k, v, out, fc1, fc2) makes
    the model's OPT int8 first (``ops/quant.quantize_opt_weights``)."""
    if set(params) != {"vision", "qformer", "projection", "opt"}:
        raise ValueError(f"BLIP-2 params hold {sorted(params)}")
    if any("w_scale" in lp["q"] for lp in params["opt"]["layers"]) and \
            model.opt.layers[0].q._buffers.get("w_scale") is None:
        from ..ops.quant import quantize_opt_weights

        with torch.no_grad():
            for p in model.opt.layers.parameters():
                p.zero_()           # the slots' values are loaded next
        quantize_opt_weights(model.opt)
    parts = dict(params)
    if lora is not None:
        parts["lora"] = lora
    if trainable is not None:
        parts.update(trainable)
    for name, tree in parts.items():
        sub = getattr(model, name, None)
        if sub is None:
            raise ValueError(f"the model has no {name!r} for the tree")
        load_jax_tree(sub, tree, allow_skipped=())
    return model
