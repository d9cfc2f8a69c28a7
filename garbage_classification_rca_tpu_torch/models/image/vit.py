"""Vision Transformer B/16 and L/16 (torchvision-compatible weights).

The port of the JAX package's ``models/image/vit.py``: patchify conv
(one strided ``F.conv2d`` — a library call, as it is plain XLA there),
class token, position embedding, pre-norm encoder layers (LayerNorm eps
1e-6, exact GELU), final LayerNorm, ``Linear(hidden, n_classes)`` on the
class token. The public functions take NHWC images, the JAX layout.

An eval layer's route is a pure function of its shape and dtype, mirroring
the JAX ``_encoder_layer``: where the attention kernel takes the shape
(``transformer_block.attn_fits``), the fused ``attn_block``; then the
fused ``mlp_block`` where ``mlp_fits``, else LayerNorm + ``core.Linear``s.
A misfit of the attention (more than 224 tokens, a head dim other than
64) and train mode go through ``core.Linear``s around the
``kernels/mha_fused`` attention kernels. Both B/16 and L/16 take the fused
pair in fp32 and bf16 (the card streams the weights; the JAX package's
VMEM limit sent L/16's MLP to the unfused graph).

``convert_torch`` maps the torchvision state-dict layout (class_token,
conv_proj, encoder.pos_embedding, encoder.layers.encoder_layer_{i}.*,
encoder.ln, heads.head) onto the JAX tree layout.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...kernels import transformer_block
from ...kernels.mha_fused import mha, mha_flash_train
from ...nn import core
from ..registry import ModelDef


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    layers: int = 12
    heads: int = 12
    hidden: int = 768
    mlp: int = 3072
    ln_eps: float = 1e-6


CONFIGS = {
    "transformer_B16": ViTConfig(),
    "transformer_L16": ViTConfig(layers=24, heads=16, hidden=1024, mlp=4096),
}


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.ln_1 = core.LayerNorm(cfg.hidden, cfg.ln_eps)
        self.qkv = core.Linear(cfg.hidden, 3 * cfg.hidden, generator=g)
        self.out = core.Linear(cfg.hidden, cfg.hidden, generator=g)
        self.ln_2 = core.LayerNorm(cfg.hidden, cfg.ln_eps)
        self.fc1 = core.Linear(cfg.hidden, cfg.mlp, generator=g)
        self.fc2 = core.Linear(cfg.mlp, cfg.hidden, generator=g)
        self._packed = transformer_block.PackedWeights()

    def packed(self):
        """The layer's weights as the fused blocks take them: (attention
        arguments, MLP arguments) after x. Built at first use and again
        only when a parameter changed (a load, a cast, a move)."""
        lins = (self.qkv, self.out, self.fc1, self.fc2)
        lns = (self.ln_1, self.ln_2)

        def build():
            attn = (self.ln_1.scale.float(), self.ln_1.bias.float(),
                    self.qkv.w.t().contiguous(), self.qkv.b.float(),
                    self.out.w.t().contiguous(), self.out.b.float())
            mlp = (self.ln_2.scale.float(), self.ln_2.bias.float(),
                   self.fc1.w.t().contiguous(), self.fc1.b.float(),
                   self.fc2.w.t().contiguous(), self.fc2.b.float())
            return attn, mlp

        return self._packed.get(
            [t for m in lins for t in (m.w, m.b)]
            + [t for m in lns for t in (m.scale, m.bias)], build)


class ViT(nn.Module):
    """Attribute names follow the JAX parameter tree."""

    def __init__(self, cfg: ViTConfig, num_classes: int = 4, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.conv_proj = core.Conv2d(cfg.patch_size, cfg.patch_size, 3,
                                     cfg.hidden, bias=True, generator=g)
        # torchvision: class_token zeros, pos_embedding N(0, 0.02)
        self.class_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden))
        self.pos_embedding = nn.Parameter(
            torch.randn((1, n_patches + 1, cfg.hidden), generator=g) * 0.02)
        self.ln = core.LayerNorm(cfg.hidden, cfg.ln_eps)
        self.head = core.Linear(cfg.hidden, num_classes, generator=g)
        self.layers = nn.ModuleList(EncoderLayer(cfg, generator=g)
                                    for _ in range(cfg.layers))

    def forward(self, x, *, train: bool = False, key=None):
        """Normalized NHWC images -> logits [B, n_classes]. `key` is
        unused: torchvision's ViT dropout is 0.0, so the train mode has no
        random site (it routes attention through the training kernels)."""
        return self.head(features(self, x, train=train))


def layer_route(p: EncoderLayer, x: torch.Tensor, heads: int, *,
                train: bool) -> str:
    """The routing rule of ``encoder_layer``: "fused" (both blocks),
    "fused_attn" (the fused attention block, unfused MLP) or "mha"."""
    b, n, d = x.shape
    if train or p.qkv.w.dtype != x.dtype \
            or not transformer_block.attn_fits(n, d, heads, x.dtype):
        return "mha"
    if transformer_block.mlp_fits(d, p.fc1.w.shape[0], x.dtype):
        return "fused"
    return "fused_attn"


def encoder_layer(p: EncoderLayer, x: torch.Tensor, heads: int, *,
                  train: bool = False) -> torch.Tensor:
    """x + MHA(LN(x)), then x + MLP(LN(x))."""
    route = layer_route(p, x, heads, train=train)
    if route == "mha":
        q, k, v = p.qkv(p.ln_1(x)).chunk(3, dim=-1)
        attention = mha_flash_train if train else mha
        att = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        heads=heads)
        x = x + p.out(att)
    else:
        attn, mlp = p.packed()
        x = transformer_block.attn_block(x, *attn, heads=heads,
                                         eps=p.ln_1.eps)
        if route == "fused":
            return transformer_block.mlp_block(x, *mlp, eps=p.ln_2.eps)
    return x + p.fc2(core.gelu(p.fc1(p.ln_2(x))))


def features(model: ViT, x: torch.Tensor, *, train: bool = False
             ) -> torch.Tensor:
    """NHWC image -> class-token feature [B, hidden]."""
    cfg = model.cfg
    h = model.conv_proj(x.permute(0, 3, 1, 2), stride=cfg.patch_size)
    h = h.flatten(2).transpose(1, 2)                         # [B, N, D]
    cls = model.class_token.to(h.dtype).expand(h.shape[0], -1, -1)
    h = torch.cat([cls, h], dim=1) + model.pos_embedding.to(h.dtype)
    for lp in model.layers:
        h = encoder_layer(lp, h, cfg.heads, train=train)
    return model.ln(h)[:, 0]


def convert_torch(sd: dict, num_classes: int = 4):
    """A torchvision ViT state dict (numpy-valued) -> (params, state) in the
    JAX tree layout, with the checkpoint's own widths and depth."""
    g = lambda k: np.asarray(sd[k])
    lin = lambda pre: {"w": g(pre + "weight").T, "b": g(pre + "bias")}
    ln = lambda pre: {"scale": g(pre + "weight"), "bias": g(pre + "bias")}
    params = {
        "conv_proj": {"w": g("conv_proj.weight").transpose(2, 3, 1, 0),
                      "b": g("conv_proj.bias")},
        "class_token": g("class_token"),
        "pos_embedding": g("encoder.pos_embedding"),
        "ln": ln("encoder.ln."),
        "head": lin("heads.head."),
        "layers": [],
    }
    if params["head"]["w"].shape[1] != num_classes:
        raise ValueError(
            f"checkpoint head has {params['head']['w'].shape[1]} classes, "
            f"expected {num_classes}")
    n_layers = len({m.group(1) for k in sd for m in [re.match(
        r"encoder\.layers\.encoder_layer_(\d+)\.", k)] if m})
    for i in range(n_layers):
        pre = f"encoder.layers.encoder_layer_{i}."
        params["layers"].append({
            "ln_1": ln(pre + "ln_1."),
            "qkv": {"w": g(pre + "self_attention.in_proj_weight").T,
                    "b": g(pre + "self_attention.in_proj_bias")},
            "out": lin(pre + "self_attention.out_proj."),
            "ln_2": ln(pre + "ln_2."),
            "fc1": lin(pre + "mlp.linear_1."),
            "fc2": lin(pre + "mlp.linear_2."),
        })
    return params, {}


def model_def(name: str) -> ModelDef:
    cfg = CONFIGS[name]

    def build(num_classes: int = 4, *, layers: int = cfg.layers,
              generator=None):
        c = cfg if layers == cfg.layers else ViTConfig(
            cfg.image_size, cfg.patch_size, layers, cfg.heads, cfg.hidden,
            cfg.mlp, cfg.ln_eps)
        return ViT(c, num_classes, generator=generator)

    return ModelDef(name=name, build=build, convert_torch=convert_torch,
                    extras={"cfg": cfg})
