"""Multimodal late fusion — the seven strategies of the reference.

The port of the JAX package's ``models/fusion/multimodal.py``: an
EfficientNetV2-M multi-stage extractor and a text tower (DistilBERT, BERT
or the bare BART-large encoder-decoder) feed one of the heads:
  * ``gated``: tanh features mixed by a softmax gate ``z``;
  * ``classic`` / ``normalized``: both features to ``num_neurons_fc``
    (L2-normalized in ``normalized``), concatenated, two linears;
  * ``clip``: the ``[bs, bs]`` cosine-similarity logits through a Linear
    sized by ``batch_size``; at another batch the reference's
    ConvTranspose1d pad hack runs, and only at batch 8 (the JAX package's
    preserved defect);
  * ``MM_RCA``: L2 norm -> 16 patches -> the fused RCA kernel -> one of
    the three MM-RCA heads;
  * ``hierarchical``: the pooled stage-3 / stage-6 maps and the tower's
    hidden states 2 and 4 beside the two features; the maps are flattened
    in NHWC order, as the JAX package flattens them;
  * ``bimodal``: three GRUs that scan ACROSS THE BATCH (time = batch, the
    reference's unbatched-GRU defect, which the JAX package keeps), so its
    predictions depend on the batch's size, order and padding.
The DistilBERT and BERT towers run with ``fused_blocks=False``: their eval
attention is the ``mha`` kernel. BART runs no kernel (``models/text/bart``).
The model builds the towers and the heads its strategy reads.

Train mode (``train=True`` with a ``core.Key``) runs every strategy on
every tower the JAX package trains it on; it adds, as the JAX forward
does: modality dropout (two coin flips per batch, ``drop_modalities``)
with every output of the dropped tower gated (``_grad_gate``: the pooled
feature, and the hidden states or the stage maps hierarchical reads),
stochastic depth and batch-statistics BatchNorm in the image tower, the
training attention kernels in the DistilBERT / BERT tower (with
``hf_internal_dropout``, the HF tower's own p = 0.1 dropout sites and the
dropout attention pair; BART's sites are plain dropout), the
differentiable RCA kernel pair (``rca_fused_trainable``), and each head's
dropout where the JAX head has it: gated on the gate, classic /
normalized on the concat layer's output, MM-RCA on the head's input,
hierarchical on both concatenations, bimodal at p = 0.86 on the fused GRU
output and on the projection; CLIP has none. BN running stats update in
place; the model must be unfolded to train.

``convert_torch`` reads the reference's all-heads checkpoint into the JAX
package's tree layout, every head included, and
``checkpoint/from_jax.load_jax_tree`` loads that tree: one path for
weights, whether they come from a ``.pth`` or from the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
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
from ..text import bart as bart_mod
from ..text import bert as bert_mod
from ..text import distilbert as distil_mod
from ..text.encoder_common import lin as _lin

# attention geometry — reference multimodal_model.py:249-264
NUM_PATCHES = 16
SA_HIDDEN = 128
SA_OUT = 96
CA_HIDDEN = 64
CA_OUT = 48
IMG_FEAT = 1280
GATED_HIDDEN = 256
# hierarchical head: pooled stage 3 (4 x 4 x 160) and stage 6 (2 x 2 x 512)
HIER_IMG = IMG_FEAT + 2560 + 2048
HIER_HIDDEN = 512
# bimodal GRU head — reference :300-328
MODALITY_DIM = 400
BIMODAL_HIDDEN = 500
BIMODAL_PROJ = 450

TEXT_TOWERS = {"distilbert": distil_mod.DistilBertEncoder,
               "bert": bert_mod.BertEncoder, "bart": bart_mod.BartModel}

# every head entry of the JAX tree (a reference checkpoint holds them all)
TREE_HEADS = (
    "image_to_hidden", "text_to_hidden", "concat", "fc", "img_feats_hidden",
    "txt_feats_hidden", "z", "fc_gated", "clip_fc", "trans_conv",
    "logit_scale", "output_all_features", "sa_img", "sa_txt", "rca_ti",
    "rca_it", "final", "final_with_everything", "final_features_only",
    "final_cross_only", "hier_img", "hier_txt", "hier_all", "gru_text",
    "gru_audio", "hadamard", "gru_bimodal", "concat_fc", "mod_img_to_dim",
    "mod_txt_to_dim", "bimodal_classifier",
)


@dataclass(frozen=True)
class FusionConfig:
    """The JAX package's FusionConfig fields (``use_pallas_rca`` aside: the
    port always runs its RCA kernel)."""
    strategy: str = "MM_RCA"
    text_model_name: str = "distilbert"
    num_classes: int = 4
    drop_ratio: float = 0.6                  # --model_dropout
    image_or_text_dropout_chance: float = 0.33   # --image_text_dropout
    img_prob_dropout: float = 0.7            # --image_prob_dropout
    num_neurons_fc: int = 256                # --num_neurons_FC
    batch_size: int = 16                     # --batch_size: the CLIP head
    reverse: bool = False                    # --reverse
    features_only: bool = False              # --features_only
    cross_attention_only: bool = False       # --cross_attention_only
    hf_internal_dropout: bool = False        # --hf_internal_dropout

    @property
    def text_hidden(self) -> int:
        return 1024 if self.text_model_name == "bart" else 768

    @property
    def txt_patch(self) -> int:
        return 768 // NUM_PATCHES

    @property
    def img_patch(self) -> int:
        return IMG_FEAT // NUM_PATCHES


def check_config(cfg: FusionConfig) -> None:
    """The JAX package's refusals, all at build time (MM-RCA with BART it
    raises at the first forward, with the same message; bimodal with BART
    it does not refuse, and fails at the first forward on the 768-wide
    ``mod_txt_to_dim``)."""
    if cfg.strategy not in LATE_FUSION_STRATEGIES:
        raise ValueError(f"unknown late-fusion strategy '{cfg.strategy}'; "
                         f"known: {list(LATE_FUSION_STRATEGIES)}")
    if cfg.text_model_name not in TEXT_TOWERS:
        raise ValueError(f"Wrong text model: {cfg.text_model_name}")
    if cfg.strategy == "hierarchical" and cfg.text_model_name == "bart":
        raise ValueError(
            "hierarchical fusion needs per-layer hidden states; "
            "--text_model=bart does not expose them (use distilbert/bert; "
            "reference taps hidden layers 2/4, multimodal_model.py:755-757)")
    if cfg.strategy == "MM_RCA" and cfg.text_hidden != 768:
        raise ValueError("MM_RCA requires a 768-d text tower "
                         "(reference patch table multimodal_model.py:257-261)")
    if cfg.strategy == "bimodal" and cfg.text_hidden != 768:
        raise ValueError(
            "bimodal fusion requires a 768-d text tower: its "
            "modality_text_to_dim is Linear(768, 400) (reference "
            f"multimodal_model.py:300-328); --text_model="
            f"{cfg.text_model_name} gives {cfg.text_hidden}")


class TransConv(nn.Module):
    """The CLIP head's ConvTranspose1d(8, 8, 2, stride 2) weights, in
    torch's layout [in, out, k] (the JAX tree keeps it too)."""

    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(torch.randn((8, 8, 2), generator=generator)
                              * 0.1)
        self.b = nn.Parameter(torch.zeros(8))


class FusionModel(nn.Module):
    """The towers + the heads of ``cfg.strategy``. Attribute names follow
    the JAX parameter tree."""

    def __init__(self, cfg: FusionConfig, *,
                 text_layers: Optional[int] = None,
                 image_cfg: Optional[eff.EffNetConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.image_cfg = image_cfg or effv2.CONFIGS["eff_v2_medium"]
        if self.image_cfg.head_out != IMG_FEAT:
            raise ValueError("late fusion needs a 1280-d image feature")
        g = generator
        n, hid, fcn = cfg.num_classes, cfg.text_hidden, cfg.num_neurons_fc
        tower = TEXT_TOWERS[cfg.text_model_name]
        self.text = (tower(generator=g) if text_layers is None
                     else tower(text_layers, generator=g))
        self.image = eff.EffNet(self.image_cfg, generator=g)
        lin = lambda i, o: core.Linear(i, o, generator=g)
        s = cfg.strategy
        if s == "MM_RCA":
            self.sa_img = AttentionUnit(cfg.img_patch, cfg.img_patch,
                                        SA_HIDDEN, SA_OUT, generator=g)
            self.sa_txt = AttentionUnit(cfg.txt_patch, cfg.txt_patch,
                                        SA_HIDDEN, SA_OUT, generator=g)
            self.rca_ti = AttentionUnit(SA_OUT, SA_OUT, CA_HIDDEN, CA_OUT,
                                        generator=g)
            self.rca_it = AttentionUnit(SA_OUT, SA_OUT, CA_HIDDEN, CA_OUT,
                                        generator=g)
            cat = CA_OUT * NUM_PATCHES * 2
            self.final_with_everything = lin(cat + IMG_FEAT + 768, n)
            if cfg.features_only:
                self.final_features_only = lin(IMG_FEAT + 768, n)
            if cfg.cross_attention_only:
                self.final_cross_only = lin(cat, n)
        elif s == "gated":
            self.img_feats_hidden = lin(IMG_FEAT, GATED_HIDDEN)
            self.txt_feats_hidden = lin(hid, GATED_HIDDEN)
            self.z = lin(2 * GATED_HIDDEN, GATED_HIDDEN)
            self.fc_gated = lin(GATED_HIDDEN, n)
        elif s in ("classic", "normalized", "clip"):
            self.image_to_hidden = lin(IMG_FEAT, fcn)
            self.text_to_hidden = lin(hid, fcn)
            if s == "clip":
                self.clip_fc = lin(cfg.batch_size, n)
                self.trans_conv = TransConv(generator=g)
                self.logit_scale = nn.Parameter(
                    torch.tensor(math.log(1 / 0.07)))
            else:
                self.concat = lin(2 * fcn, fcn)
                self.fc = lin(fcn, n)
        elif s == "hierarchical":
            self.hier_img = lin(HIER_IMG, HIER_HIDDEN)
            self.hier_txt = lin(3 * hid, HIER_HIDDEN)
            self.hier_all = lin(2 * HIER_HIDDEN, n)
        else:                                           # bimodal
            gru = lambda i, o: core.GRU(i, o, generator=g)
            self.gru_text = gru(MODALITY_DIM, MODALITY_DIM)
            self.gru_audio = gru(MODALITY_DIM, MODALITY_DIM)
            self.hadamard = core.Hadamard(MODALITY_DIM, generator=g)
            self.gru_bimodal = gru(MODALITY_DIM, BIMODAL_HIDDEN)
            self.concat_fc = lin(MODALITY_DIM + BIMODAL_HIDDEN, BIMODAL_PROJ)
            self.mod_img_to_dim = lin(IMG_FEAT, MODALITY_DIM)
            self.mod_txt_to_dim = lin(hid, MODALITY_DIM)
            self.bimodal_classifier = lin(BIMODAL_PROJ, n)

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


def _text_encode(cfg: FusionConfig, p: FusionModel, ids, mask, *,
                 need_hiddens=False, train=False, drop=None):
    """-> (the tower's feature [B, hid], its hidden states or None): the
    CLS state of DistilBERT / BERT (off the fused post-norm blocks, as in
    the JAX package: their eval attention is the mha kernel), BART's
    decoder state at position 0."""
    if cfg.text_model_name == "bart":
        return bart_mod.encode_decoder(p.text, ids, mask, drop)[:, 0], None
    mod = distil_mod if cfg.text_model_name == "distilbert" else bert_mod
    out = mod.encode(p.text, ids, mask, train=train, drop=drop,
                     fused_blocks=False, output_hidden_states=need_hiddens)
    h, hiddens = out if need_hiddens else (out, None)
    return h[:, 0], hiddens


def _towers(cfg: FusionConfig, p: FusionModel, images, ids, mask, *,
            need_hiddens=False, train=False, key=None, keeps=(None, None)):
    """-> (text feature, hidden states or None, stage-3 map NHWC, stage-6
    map NHWC, pooled image feature), each gated by its tower's keep flag."""
    drop = None
    if cfg.hf_internal_dropout and train and key is not None:
        # fold_in, not split: the image tower's stream, and with it every
        # flag-off run, stays as it was
        drop = core.HFDropout(key.fold_in(0x4F1D))
    text, hiddens = _text_encode(cfg, p, ids, mask, need_hiddens=need_hiddens,
                                 train=train, drop=drop)
    s3, s6, img = effv2.extractor_features(p.image, images, p.image_cfg,
                                           train=train, key=key)
    img_keep, txt_keep = keeps
    if hiddens is not None:
        hiddens = [_grad_gate(h, txt_keep) for h in hiddens]
    return (_grad_gate(text, txt_keep), hiddens, _grad_gate(s3, img_keep),
            _grad_gate(s6, img_keep), _grad_gate(img, img_keep))


def _l2n(x):
    return core.l2_normalize(x, dim=1, eps=1e-12)


def mm_rca_block(cfg: FusionConfig, p: FusionModel, img_feat, txt_feat):
    """L2-norm -> patches -> fused RCA kernel -> flatten. With gradients
    enabled the block is the differentiable kernel pair
    (``rca_fused_trainable``: forward K1, backward K3)."""
    img_n = _l2n(img_feat)
    txt_n = _l2n(txt_feat)
    bs = txt_n.shape[0]
    t = txt_n.reshape(bs, NUM_PATCHES, cfg.txt_patch)
    i = img_n.reshape(bs, NUM_PATCHES, cfg.img_patch)
    rca = rca_fused_trainable if torch.is_grad_enabled() else rca_fused
    ti, it = rca(p, t, i, reverse=cfg.reverse)
    return ti.reshape(bs, -1), it.reshape(bs, -1), img_n, txt_n


def _drop(x, rate, key: Optional[core.Key]):
    """A head's dropout: in train mode (a key given) ``core.dropout`` on
    the key's stream, else the identity."""
    return x if key is None else core.dropout(x, rate,
                                              key.generator(x.device))


def _halves(key: Optional[core.Key]):
    return key.split(2) if key is not None else (None, None)


def _mm_rca(cfg, p, text, img, *, key=None, **_):
    # :636-728
    ti, it, img_n, txt_n = mm_rca_block(cfg, p, img, text)
    if cfg.features_only:
        concat, head = torch.cat([img_n, txt_n], dim=1), p.final_features_only
    elif cfg.cross_attention_only:
        concat, head = torch.cat([ti, it], dim=1), p.final_cross_only
    else:
        concat = torch.cat([ti, it, img_n, txt_n], dim=1)
        head = p.final_with_everything
    return head(_drop(concat, cfg.drop_ratio, key))


def _gated(cfg, p, text, img, *, key=None, **_):
    # reference multimodal_model.py:331-395
    ih, th = p.img_feats_hidden(img), p.txt_feats_hidden(text)
    cat = torch.cat([ih, th], dim=1)       # the towers' dtypes promoted
    zl = torch.softmax(p.z(cat).float(), dim=1).to(cat.dtype)
    gate = zl * torch.tanh(ih) + (1 - zl) * torch.tanh(th)
    return p.fc_gated(_drop(gate, cfg.drop_ratio, key))


def _concat(cfg, p, text, img, *, key=None, **_):
    # classic :489-531, normalized :534-579
    ih, th = p.image_to_hidden(img), p.text_to_hidden(text)
    if cfg.strategy == "normalized":
        ih, th = _l2n(ih), _l2n(th)
    h = p.concat(torch.cat([ih, th], dim=1))
    return p.fc(_drop(h, cfg.drop_ratio, key))


def _clip(cfg, p, text, img, **_):
    # :583-633; the trans_conv pad hack fires when bs != cfg.batch_size;
    # no dropout in train mode either
    img, txt = _l2n(p.image_to_hidden(img)), _l2n(p.text_to_hidden(text))
    # in the promoted dtype, as the JAX head's arrays promote (fp32 when
    # bf16 images meet the fp32 text tower and weights of training)
    dt = torch.promote_types(torch.promote_types(img.dtype, txt.dtype),
                             p.logit_scale.dtype)
    logits = (torch.exp(p.logit_scale.to(dt)) * img.to(dt)) \
        @ txt.to(dt).T                                     # [bs, bs]
    if logits.shape[0] != cfg.batch_size:
        # the reference feeds the UNBATCHED [b, b] tensor to
        # ConvTranspose1d(8, 8, 2, stride 2), which takes dim 0 as the
        # channels: it runs only when the batch is 8, giving [8, 2b]
        w = p.trans_conv.w.to(logits.dtype)
        if logits.shape[0] != w.shape[0]:
            raise ValueError(
                f"CLIP trans_conv pad hack needs batch {w.shape[0]}, got "
                f"{logits.shape[0]} (reference defect, "
                "multimodal_model.py:625)")
        y = torch.stack([w[:, :, 0].T @ logits, w[:, :, 1].T @ logits],
                        dim=-1).reshape(w.shape[1], -1)   # interleaved
        logits = y + p.trans_conv.b.to(y.dtype)[:, None]
    return p.clip_fc(logits)


def _hierarchical(cfg, p, text, img, *, hiddens, s3, s6, key=None, **_):
    # :729-818; AvgPool2d(7, 7) of stage 3 [B, 30, 30, 160] -> 4 x 4 x 160,
    # AvgPool2d(6, 6) of stage 6 [B, 15, 15, 512] -> 2 x 2 x 512, each
    # flattened in (h, w, c) order, as the JAX package does
    b = img.shape[0]
    s3p = _l2n(core.avg_pool(s3, 7, 7).reshape(b, -1))
    s6p = _l2n(core.avg_pool(s6, 6, 6).reshape(b, -1))
    cat_img = torch.cat([_l2n(img), s3p, s6p], dim=1)
    cat_txt = torch.cat([_l2n(text), _l2n(hiddens[2][:, 0]),
                         _l2n(hiddens[4][:, 0])], dim=1)
    k1, k2 = _halves(key)
    hi = core.relu(p.hier_img(_drop(cat_img, cfg.drop_ratio, k1)))
    ht = core.relu(p.hier_txt(_drop(cat_txt, cfg.drop_ratio, k2)))
    return p.hier_all(torch.cat([hi, ht], dim=1))


def _bimodal(cfg, p, text, img, *, key=None, **_):
    # :835-888: each GRU scans the batch's rows as its time steps; train
    # mode drops the fused scan and the projection at p = 0.86, not
    # drop_ratio (the reference's fixed rate)
    x_text = p.mod_txt_to_dim(_l2n(text))                  # [B, 400]
    x_img = p.mod_img_to_dim(_l2n(img))
    fused = p.hadamard(p.gru_text(x_text), p.gru_audio(x_img))
    k1, k2 = _halves(key)
    combined = torch.cat([fused, _drop(p.gru_bimodal(fused), 0.86, k1)],
                         dim=-1)
    proj = _drop(core.relu(p.concat_fc(combined)), 0.86, k2)
    return p.bimodal_classifier(proj)


_HEADS = {"MM_RCA": _mm_rca, "gated": _gated, "classic": _concat,
          "normalized": _concat, "clip": _clip,
          "hierarchical": _hierarchical, "bimodal": _bimodal}


def forward(cfg: FusionConfig, p: FusionModel, batch, *, train=False,
            key: Optional[core.Key] = None, remove_image=False,
            remove_text=False):
    """batch = (input_ids int32 [B, L], attention_mask int32 [B, L],
    images normalized NHWC) -> logits [B, num_classes] (CLIP's pad hack:
    [8, num_classes] whatever the batch's samples).

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
    text, hiddens, s3, s6, img = _towers(
        cfg, p, images, input_ids, attention_mask,
        need_hiddens=cfg.strategy == "hierarchical", train=train,
        key=k_model, keeps=(img_keep, txt_keep))
    return _HEADS[cfg.strategy](cfg, p, text, img, hiddens=hiddens, s3=s3,
                                s6=s6, key=k_head)


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


def _gru(sd, pre):
    return {"w_ih": np.asarray(sd[pre + ".weight_ih_l0"]).T,
            "w_hh": np.asarray(sd[pre + ".weight_hh_l0"]).T,
            "b_ih": np.asarray(sd[pre + ".bias_ih_l0"]),
            "b_hh": np.asarray(sd[pre + ".bias_hh_l0"])}


def convert_torch(sd: dict, cfg: FusionConfig,
                  image_cfg: Optional[eff.EffNetConfig] = None):
    """Reference all-heads fusion state dict -> (params, state) numpy trees
    in the JAX layout, every head included (the optional MM-RCA ablation
    heads where the dict has them)."""
    check_config(cfg)
    image_cfg = image_cfg or effv2.CONFIGS["eff_v2_medium"]
    img_params, img_state = eff.convert_torch(_image_sd_to_features(sd),
                                              image_cfg)
    text_sd = subdict(sd, "text_model.")
    if cfg.text_model_name == "bart":
        text = bart_mod.convert_torch(text_sd, num_classes=cfg.num_classes)[0]
    elif cfg.text_model_name == "bert":
        text = bert_mod.convert_encoder(text_sd)
    else:
        text = distil_mod.convert_encoder(text_sd)
    params = {
        "text": text,
        "image": img_params,
        "image_to_hidden": _lin(sd, "image_to_hidden_size"),
        "text_to_hidden": _lin(sd, "text_to_hidden_size"),
        "concat": _lin(sd, "concat_layer"),
        "fc": _lin(sd, "fc_layer"),
        "img_feats_hidden": _lin(sd, "image_features_hidden_layer"),
        "txt_feats_hidden": _lin(sd, "text_features_hidden_layer"),
        "z": _lin(sd, "z_layer"),
        "fc_gated": _lin(sd, "fc_layer_gated"),
        "clip_fc": _lin(sd, "clip_fc_layer"),
        "trans_conv": {"w": np.asarray(sd["trans_conv.weight"]),
                       "b": np.asarray(sd["trans_conv.bias"])},
        "logit_scale": np.asarray(sd["logit_scale"]),
        "output_all_features": _lin(sd, "output_all_features"),
        "sa_img": _att_block(sd, "self_attention_image"),
        "sa_txt": _att_block(sd, "self_attention_text"),
        "rca_ti": _att_block(sd, "cross_attention_1"),
        "rca_it": _att_block(sd, "cross_attention_2"),
        "final": _lin(sd, "final"),
        "final_with_everything": _lin(sd, "final_with_everything"),
        "hier_img": _lin(sd, "final_hierarchical_image"),
        "hier_txt": _lin(sd, "final_hierarchical_text"),
        "hier_all": _lin(sd, "final_hierarchical_all"),
        "gru_text": _gru(sd, "gru_text"),
        "gru_audio": _gru(sd, "gru_audio"),
        "hadamard": {"kernel1": np.asarray(sd["fusion.kernel1"]),
                     "kernel2": np.asarray(sd["fusion.kernel2"]),
                     "bias": np.asarray(sd["fusion.bias"])},
        "gru_bimodal": _gru(sd, "gru_bimodal"),
        "concat_fc": _lin(sd, "concat_fc"),
        "mod_img_to_dim": _lin(sd, "modality_image_to_dim"),
        "mod_txt_to_dim": _lin(sd, "modality_text_to_dim"),
        "bimodal_classifier": _lin(sd, "classifier"),
    }
    if "final_features_only_linear.weight" in sd:
        params["final_features_only"] = _lin(sd, "final_features_only_linear")
    if "cross_attention_only_linear.weight" in sd:
        params["final_cross_only"] = _lin(sd, "cross_attention_only_linear")
    return params, {"image": img_state}


def _text_depth(text_tree: dict) -> int:
    """The text tower's depth in a JAX-layout tree (BART: per stack)."""
    return len(text_tree["enc_layers"] if "enc_layers" in text_tree
               else text_tree["layers"])


def load_fusion_model(params, state, cfg: FusionConfig, *, device="cuda",
                      image_cfg: Optional[eff.EffNetConfig] = None
                      ) -> FusionModel:
    """A FusionModel holding the weights of the JAX-layout trees, on
    `device`. The trees may carry every other strategy's heads (a
    reference checkpoint does); those are left out."""
    dev = resolve_device(device)
    model = FusionModel(cfg, text_layers=_text_depth(params["text"]),
                        image_cfg=image_cfg)
    load_jax_tree(model, params, state,
                  allow_skipped=TREE_HEADS + ("image.classifier",))
    return model.to(dev).eval()
