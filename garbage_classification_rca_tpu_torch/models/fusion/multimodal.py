"""Multimodal late fusion — the MM-RCA strategy, eval and train.

The port of the JAX package's ``models/fusion/multimodal.py`` for the
headline path: an EfficientNetV2-M multi-stage extractor and a DistilBERT
tower feed ``mm_rca_block`` (L2 norm -> 16 patches -> the fused RCA
kernel), then one of the three MM-RCA heads.

Train mode (``train=True`` with a ``core.Key``) adds, as the JAX forward
does: modality dropout (two coin flips per batch, ``drop_modalities``)
with the dropped tower's cotangent cut (``_grad_gate``), stochastic depth
and batch-statistics BatchNorm in the image tower, the training attention
kernels in the text tower (with ``hf_internal_dropout``, the HF tower's
own p = 0.1 dropout sites and the dropout attention pair), the
differentiable RCA kernel pair (``rca_fused_trainable``), and dropout on
the head's input. BN running
stats update in place; the model must be unfolded to train. The other six strategies
(gated, classic, normalized, clip, hierarchical, bimodal) and the
bert/bart towers are still to port (ROADMAP.md); asking for them raises
``NotImplementedError``.

``convert_torch`` reads the reference's all-heads checkpoint into the JAX
package's tree layout, and ``checkpoint/from_jax.load_jax_tree`` loads
that tree: one path for weights, whether they come from a ``.pth`` or from
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ...checkpoint.from_jax import load_jax_tree
from ...checkpoint.torch_convert import subdict
from ...config import LATE_FUSION_STRATEGIES
from ...device import resolve_device
from ...kernels.rca_fused import rca_fused, rca_fused_trainable
from ...nn import core
from ...ops.attention import AttentionUnit
from ..image import efficientnet_common as eff
from ..image import efficientnet_v2 as effv2
from ..text import distilbert as distil_mod
from ..text.encoder_common import lin as _lin

PORTED_STRATEGIES = ("MM_RCA",)

# attention geometry — reference multimodal_model.py:249-264
NUM_PATCHES = 16
SA_HIDDEN = 128
SA_OUT = 96
CA_HIDDEN = 64
CA_OUT = 48
IMG_FEAT = 1280

# tree entries of the other strategies' heads: in every reference
# checkpoint, not used by MM_RCA
OTHER_HEADS = (
    "image_to_hidden", "text_to_hidden", "concat", "fc", "img_feats_hidden",
    "txt_feats_hidden", "z", "fc_gated", "clip_fc", "trans_conv",
    "logit_scale", "output_all_features", "final", "hier_img", "hier_txt",
    "hier_all", "gru_text", "gru_audio", "hadamard", "gru_bimodal",
    "concat_fc", "mod_img_to_dim", "mod_txt_to_dim", "bimodal_classifier",
)


@dataclass(frozen=True)
class FusionConfig:
    """The JAX package's FusionConfig fields that MM-RCA reads; the other
    strategies' fields arrive with those slices."""
    strategy: str = "MM_RCA"
    text_model_name: str = "distilbert"
    num_classes: int = 4
    drop_ratio: float = 0.6                  # --model_dropout
    image_or_text_dropout_chance: float = 0.33   # --image_text_dropout
    img_prob_dropout: float = 0.7            # --image_prob_dropout
    reverse: bool = False                    # --reverse
    features_only: bool = False              # --features_only
    cross_attention_only: bool = False       # --cross_attention_only
    hf_internal_dropout: bool = False        # --hf_internal_dropout

    @property
    def txt_patch(self) -> int:
        return 768 // NUM_PATCHES

    @property
    def img_patch(self) -> int:
        return IMG_FEAT // NUM_PATCHES


def check_config(cfg: FusionConfig) -> None:
    if cfg.strategy not in LATE_FUSION_STRATEGIES:
        raise ValueError(f"unknown late-fusion strategy '{cfg.strategy}'; "
                         f"known: {list(LATE_FUSION_STRATEGIES)}")
    if cfg.strategy not in PORTED_STRATEGIES:
        raise NotImplementedError(
            f"late fusion '{cfg.strategy}' is not ported to PyTorch yet "
            "(ROADMAP.md, queue 1); the JAX package runs it")
    if cfg.text_model_name != "distilbert":
        raise NotImplementedError(
            f"text tower '{cfg.text_model_name}' is not ported to PyTorch "
            "yet (ROADMAP.md, queue 1); the JAX package runs it")


class FusionModel(nn.Module):
    """Towers + MM-RCA units + the MM-RCA heads. Attribute names follow
    the JAX parameter tree."""

    def __init__(self, cfg: FusionConfig, *, text_layers: int = 6,
                 image_cfg: Optional[eff.EffNetConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.image_cfg = image_cfg or effv2.CONFIGS["eff_v2_medium"]
        if self.image_cfg.head_out != IMG_FEAT:
            raise ValueError("MM_RCA needs a 1280-d image feature")
        g = generator
        n = cfg.num_classes
        self.text = distil_mod.DistilBertEncoder(text_layers, generator=g)
        self.image = eff.EffNet(self.image_cfg, generator=g)
        self.sa_img = AttentionUnit(cfg.img_patch, cfg.img_patch, SA_HIDDEN,
                                    SA_OUT, generator=g)
        self.sa_txt = AttentionUnit(cfg.txt_patch, cfg.txt_patch, SA_HIDDEN,
                                    SA_OUT, generator=g)
        self.rca_ti = AttentionUnit(SA_OUT, SA_OUT, CA_HIDDEN, CA_OUT,
                                    generator=g)
        self.rca_it = AttentionUnit(SA_OUT, SA_OUT, CA_HIDDEN, CA_OUT,
                                    generator=g)
        cat = CA_OUT * NUM_PATCHES * 2
        self.final_with_everything = core.Linear(cat + IMG_FEAT + 768, n,
                                                 generator=g)
        if cfg.features_only:
            self.final_features_only = core.Linear(IMG_FEAT + 768, n,
                                                   generator=g)
        if cfg.cross_attention_only:
            self.final_cross_only = core.Linear(cat, n, generator=g)

    def forward(self, input_ids, attention_mask, images, *, train=False,
                key=None, remove_image=False, remove_text=False):
        return forward(self.cfg, self, (input_ids, attention_mask, images),
                       train=train, key=key, remove_image=remove_image,
                       remove_text=remove_text)


def build_fusion_model(cfg: FusionConfig, *, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       **kw) -> FusionModel:
    """FusionModel with weights drawn on the CPU from `generator` (the same
    weights whatever the device), then moved to `device`."""
    dev = resolve_device(device)
    return FusionModel(cfg, generator=generator, **kw).to(dev).eval()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def drop_modalities(cfg: FusionConfig, images, input_ids, attention_mask,
                    *, uniforms=None, remove_image=False, remove_text=False):
    """Returns (images, input_ids, attention_mask, img_keep, txt_keep).

    Eval (no ``uniforms``): forced removal, zeroed images or zeroed ids and
    mask; the keep flags are None. Train: two uniforms (device scalars)
    decide, as the JAX forward's two coin flips do: the batch drops a
    modality when ``u1 < image_or_text_dropout_chance``, the image when
    also ``u2 < img_prob_dropout``, else the text. The keep flags are 0-dim
    bool tensors that gate the dropped tower's gradient (``_grad_gate``)."""
    if uniforms is None:
        if remove_image:
            images = torch.zeros_like(images)
        if remove_text:
            input_ids = torch.zeros_like(input_ids)
            attention_mask = torch.zeros_like(attention_mask)
        return images, input_ids, attention_mask, None, None
    drop_any = uniforms[0] < cfg.image_or_text_dropout_chance
    drop_image = uniforms[1] < cfg.img_prob_dropout
    img_keep = ~(drop_any & drop_image)
    txt_keep = ~(drop_any & ~drop_image)
    images = images * img_keep.to(images.dtype)
    input_ids = input_ids * txt_keep.to(input_ids.dtype)
    attention_mask = attention_mask * txt_keep.to(attention_mask.dtype)
    return images, input_ids, attention_mask, img_keep, txt_keep


def _grad_gate(x, keep):
    """Identity forward; no gradient into `x` where `keep` is False. BN in
    train mode on an all-zero batch would blow the dropped tower's
    cotangent up by rsqrt(eps) per layer (the JAX package's note)."""
    if keep is None:
        return x
    return torch.where(keep, x, x.detach())


def mm_rca_block(cfg: FusionConfig, p: FusionModel, img_feat, txt_feat):
    """L2-norm -> patches -> fused RCA kernel -> flatten. With gradients
    enabled the block is the differentiable kernel pair
    (``rca_fused_trainable``: forward K1, backward K3)."""
    img_n = core.l2_normalize(img_feat, dim=1, eps=1e-12)
    txt_n = core.l2_normalize(txt_feat, dim=1, eps=1e-12)
    bs = txt_n.shape[0]
    t = txt_n.reshape(bs, NUM_PATCHES, cfg.txt_patch)
    i = img_n.reshape(bs, NUM_PATCHES, cfg.img_patch)
    rca = rca_fused_trainable if torch.is_grad_enabled() else rca_fused
    ti, it = rca(p, t, i, reverse=cfg.reverse)
    return ti.reshape(bs, -1), it.reshape(bs, -1), img_n, txt_n


def _fwd_mm_rca(cfg: FusionConfig, p: FusionModel, images, ids, mask, *,
                train=False, key=None, keeps=(None, None)):
    drop = None
    if cfg.hf_internal_dropout and train and key is not None:
        # fold_in, not split: the image tower's stream, and with it every
        # flag-off run, stays as it was
        drop = core.HFDropout(key.fold_in(0x4F1D))
    # the fusion tower stays off the fused post-norm blocks, as in the JAX
    # package: its eval attention is the mha kernel
    text = distil_mod.encode(p.text, ids, mask, train=train, drop=drop,
                             fused_blocks=False)[:, 0]
    _, _, img = effv2.extractor_features(p.image, images, p.image_cfg,
                                         train=train, key=key)
    img_keep, txt_keep = keeps
    text, img = _grad_gate(text, txt_keep), _grad_gate(img, img_keep)
    ti, it, img_n, txt_n = mm_rca_block(cfg, p, img, text)
    if cfg.features_only:
        concat, head = torch.cat([img_n, txt_n], dim=1), p.final_features_only
    elif cfg.cross_attention_only:
        concat, head = torch.cat([ti, it], dim=1), p.final_cross_only
    else:
        concat = torch.cat([ti, it, img_n, txt_n], dim=1)
        head = p.final_with_everything
    return concat, head


def forward(cfg: FusionConfig, p: FusionModel, batch, *, train=False,
            key: Optional[core.Key] = None, remove_image=False,
            remove_text=False):
    """batch = (input_ids int32 [B, L], attention_mask int32 [B, L],
    images normalized NHWC) -> logits [B, num_classes].

    Eval by default (the JAX forward's ``eval_mode=True``: modalities are
    removed only when asked). ``train=True`` needs a ``key``, which splits
    into the modality-dropout, tower and head streams as the JAX forward's
    rng does."""
    check_config(cfg)
    input_ids, attention_mask, images = batch
    if train and key is None:
        raise ValueError("train mode needs a key")
    k_drop, k_model, k_head = key.split(3) if train else (None, None, None)
    uniforms = None
    if train:
        uniforms = torch.rand(2, generator=k_drop.generator(images.device),
                              device=images.device)
    images, input_ids, attention_mask, img_keep, txt_keep = drop_modalities(
        cfg, images, input_ids, attention_mask, uniforms=uniforms,
        remove_image=remove_image, remove_text=remove_text)
    concat, head = _fwd_mm_rca(cfg, p, images, input_ids, attention_mask,
                               train=train, key=k_model,
                               keeps=(img_keep, txt_keep))
    if train:
        concat = core.dropout(concat, cfg.drop_ratio,
                              k_head.generator(concat.device))
    return head(concat)


# ---------------------------------------------------------------------------
# reference .pth conversion
# ---------------------------------------------------------------------------


def _image_sd_to_features(sd: dict) -> dict:
    """Rename the reference extractor's keys (image_model.stem / stage{i} /
    final_conv) back to torchvision's features.{i}."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("image_model."):
            continue
        r = k[len("image_model."):]
        if r.startswith("stem.0."):
            out["features.0." + r[len("stem.0."):]] = v
        elif r.startswith("stem.1."):
            out["features.1." + r[len("stem.1."):]] = v
        elif r.startswith("stage"):
            out[f"features.{int(r[len('stage')]) + 1}." + r.split(".", 1)[1]] = v
        elif r.startswith("final_conv."):
            out["features.8." + r[len("final_conv."):]] = v
    return out


def _att_block(sd, pre):
    return {"q": _lin(sd, pre + ".W_query"), "k": _lin(sd, pre + ".W_key"),
            "v": _lin(sd, pre + ".W_value"),
            "norm": {"scale": sd[pre + ".norm.weight"],
                     "bias": sd[pre + ".norm.bias"]}}


def convert_torch(sd: dict, cfg: FusionConfig,
                  image_cfg: Optional[eff.EffNetConfig] = None):
    """Reference all-heads fusion state dict -> (params, state) numpy trees
    in the JAX layout, with the MM-RCA entries (other heads are left out)."""
    check_config(cfg)
    image_cfg = image_cfg or effv2.CONFIGS["eff_v2_medium"]
    img_params, img_state = eff.convert_torch(_image_sd_to_features(sd),
                                              image_cfg)
    params = {
        "text": distil_mod.convert_encoder(subdict(sd, "text_model.")),
        "image": img_params,
        "sa_img": _att_block(sd, "self_attention_image"),
        "sa_txt": _att_block(sd, "self_attention_text"),
        "rca_ti": _att_block(sd, "cross_attention_1"),
        "rca_it": _att_block(sd, "cross_attention_2"),
        "final_with_everything": _lin(sd, "final_with_everything"),
    }
    if cfg.features_only:
        params["final_features_only"] = _lin(sd, "final_features_only_linear")
    if cfg.cross_attention_only:
        params["final_cross_only"] = _lin(sd, "cross_attention_only_linear")
    return params, {"image": img_state}


def load_fusion_model(params, state, cfg: FusionConfig, *, device="cuda",
                      image_cfg: Optional[eff.EffNetConfig] = None
                      ) -> FusionModel:
    """A FusionModel holding the weights of the JAX-layout trees, on
    `device`. The trees may carry every other strategy's heads (a
    reference checkpoint does); those are left out."""
    dev = resolve_device(device)
    model = FusionModel(cfg, text_layers=len(params["text"]["layers"]),
                        image_cfg=image_cfg)
    optional = ("final_features_only", "final_cross_only", "image.classifier")
    load_jax_tree(model, params, state,
                  allow_skipped=OTHER_HEADS + optional)
    return model.to(dev).eval()
