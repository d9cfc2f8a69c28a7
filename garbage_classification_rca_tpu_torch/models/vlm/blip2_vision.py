"""BLIP-2 vision tower: EVA ViT-g/14 as shipped in HF ``Blip2VisionModel``.

The port of the JAX package's ``models/vlm/blip2_vision.py``, eval only.
Class + patch + position embeddings, pre-LN encoder layers with a PACKED
qkv projection (the EVA k-bias is zero inside the checkpoint, so the full
bias is carried), exact-GELU MLP, ``post_layernorm`` on the sequence
output. Defaults are ``Salesforce/blip2-opt-2.7b``'s: 39 layers, hidden
1408, 16 heads (head dim 88), ffn 6144, patch 14, image 224 (257 tokens),
LayerNorm eps 1e-6.

Every layer follows the JAX package's full-size route: LayerNorm, the
packed QKV linear, the ``mha`` kernel (K2, unmasked, at head dim 88 on the
card), the projection, LayerNorm, fc1, GELU, fc2. The JAX package's fused
K6 branch serves only configurations whose weights fit its TPU VMEM budget
(``blocks_fit``), the tiny test configs; the port computes the same
function on every configuration through the route above.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ...kernels.mha_fused import mha
from ...nn import core
from ..text.encoder_common import lin, ln_


@dataclass(frozen=True)
class VisionConfig:
    layers: int = 39
    hidden: int = 1408
    heads: int = 16
    ffn: int = 6144
    patch: int = 14
    image_size: int = 224
    ln_eps: float = 1e-6

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1


class VisionLayer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d = cfg.hidden
        self.ln1 = core.LayerNorm(d, cfg.ln_eps)
        self.qkv = core.Linear(d, 3 * d)
        self.proj = core.Linear(d, d)
        self.ln2 = core.LayerNorm(d, cfg.ln_eps)
        self.fc1 = core.Linear(d, cfg.ffn)
        self.fc2 = core.Linear(cfg.ffn, d)

    def forward(self, x, heads: int):
        h = self.ln1(x)
        q, k, v = (t.contiguous() for t in self.qkv(h).chunk(3, dim=-1))
        x = x + self.proj(mha(q, k, v, heads=heads))
        return x + self.fc2(core.gelu(self.fc1(self.ln2(x))))


class VisionTower(nn.Module):
    """The tree of the JAX ``blip2_vision.init``."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden
        self.class_emb = nn.Parameter(torch.zeros(d))
        self.patch_emb = core.Conv2d(cfg.patch, cfg.patch, 3, d, bias=True)
        self.pos_emb = nn.Parameter(torch.zeros(cfg.tokens, d))
        self.post_ln = core.LayerNorm(d, cfg.ln_eps)
        self.layers = nn.ModuleList(VisionLayer(cfg)
                                    for _ in range(cfg.layers))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC CLIP-normalized images -> [B, 257, hidden]
        (post-layernormed)."""
        cfg = self.cfg
        h = self.patch_emb(pixel_values.permute(0, 3, 1, 2),
                           stride=cfg.patch)
        h = h.flatten(2).transpose(1, 2)             # (h, w) row-major
        cls = self.class_emb.to(h.dtype).expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1)
        h = h + self.pos_emb[None, :h.shape[1]].to(h.dtype)
        for layer in self.layers:
            h = layer(h, cfg.heads)
        return self.post_ln(h)


def convert_torch(sd, cfg: VisionConfig):
    """HF keys under ``vision_model.*`` (prefix-stripped) -> the JAX tree
    layout."""
    w = np.asarray(sd["embeddings.patch_embedding.weight"])
    params = {
        "class_emb": np.asarray(sd["embeddings.class_embedding"]).reshape(-1),
        "patch_emb": {"w": w.transpose(2, 3, 1, 0),
                      "b": np.asarray(sd["embeddings.patch_embedding.bias"])},
        "pos_emb": np.asarray(sd["embeddings.position_embedding"]).reshape(
            -1, cfg.hidden),
        "post_ln": ln_(sd, "post_layernorm"),
        "layers": [],
    }
    for i in range(cfg.layers):
        pre = f"encoder.layers.{i}."
        params["layers"].append({
            "ln1": ln_(sd, pre + "layer_norm1"),
            "qkv": lin(sd, pre + "self_attn.qkv"),
            "proj": lin(sd, pre + "self_attn.projection"),
            "ln2": ln_(sd, pre + "layer_norm2"),
            "fc1": lin(sd, pre + "mlp.fc1"),
            "fc2": lin(sd, pre + "mlp.fc2"),
        })
    return params
