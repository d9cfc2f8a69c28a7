"""Reference ``.pth`` checkpoint loading (the port's own copy of the JAX
package's ``checkpoint/torch_convert.py`` helpers).

The reference saves ``torch.save(model.state_dict())``; BLIP-2 checkpoints
may wrap the dict under ``'model_state_dict'``, and ``nn.DataParallel``
training adds a ``module.`` prefix. This normalizes all of that into a flat
``{name: np.ndarray}`` dict; the per-model converters map it onto the JAX
package's parameter-tree layout, which ``checkpoint/from_jax.py`` loads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):      # nn.DataParallel prefix
            k = k[len("module."):]
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().float().numpy() \
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
    return out


def convert_checked(convert_fn, sd, what: str, **kw):
    """Run a converter with a readable error when the checkpoint's key
    layout does not match the requested architecture."""
    try:
        return convert_fn(sd, **kw)
    except KeyError as e:
        sample = sorted(sd)[:3]
        raise SystemExit(
            f"checkpoint does not match {what}: converter needs key {e} "
            f"but the file contains keys like {sample}. Did you pass the "
            "right --image_model/--text_model/--late_fusion for this "
            ".pth?") from e


def subdict(sd, prefix: str):
    """Prefix-stripped sub-dict. A state dict that records its reads
    (``child``, as the JAX package's ``TrackingDict``) hands out a child
    whose reads it records too."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd.child(prefix, out) if hasattr(sd, "child") else out
