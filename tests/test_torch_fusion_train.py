"""PyTorch port, the late-fusion train path: one SGD train step of every
(strategy, tower) pair the JAX package trains, the port's
``make_train_step`` against the JAX package's on the same weights and the
same microbatch stack, with the phase-1 mask (towers frozen in the
optimizer, every gradient still taken) and all trainable.

The pattern of ``tests/test_torch_train_step.py``: the JAX trees' structure
from ``jax.eval_shape`` of the JAX ``init`` (no arrays drawn), filled from a
numpy seed, keeping the towers and the heads of the pair's strategy,
loaded on both sides; random sites off (``drop_ratio = 0``, no modality
dropout, stochastic depth 0, and bimodal's fixed p = 0.86 head dropout
made the identity on both sides: their draws differ by design and are
held to each other site by site in ``test_torch_fusion_train_sites.py``);
SGD with weight decay, class weights and label smoothing; two
microbatches of 3, the second with a padded tail. The short 7-stage
EfficientNet table at 64x64 with the real 1280-d head; DistilBERT / BERT
at 2 layers; BART-large at full width, 2 + 2 layers, a 1000-token
vocabulary. Hierarchical pools stage 3 and stage 6: its table keeps
EfficientNetV2-M's widths there (160, 512) and strides 1 before stage 5,
so that a 60x60 input gives the 30x30 and 15x15 maps a 480x480 input
gives the full tower (the head's pooled 4 x 4 x 160 and 2 x 2 x 512);
its other stages are narrow and unexpanded, because XLA:CPU runs the
wide depthwise convolutions inside the JAX step's scan ~80x slower than
outside it (a step of the depth-1 table at 480x480: ~3 minutes). It taps
hidden states 2 and 4, so its tower has 4 layers. fp32: loss, per-microbatch losses, grad_norm, param_norm, every
updated parameter and every BN running stat within 5e-5.

The JAX step runs once per pair, all trainable (one compile: the
optimizer's mask is static in it). The phase-1 case holds the port's
masked step to what the JAX package's masked SGD step computes from it,
leaf by leaf: the same loss, losses and grad_norm (taken before the
update), the heads' updated leaves, the towers' leaves as they were, the
BN statistics (updated by the forward whatever the mask), the norm of
those parameters; and the port's mask equals the JAX CLI's
``fusion_head_mask``.

This file holds the DistilBERT pairs and the helpers;
``test_torch_fusion_train_bert.py`` the BERT pairs and
``test_torch_bart_train.py`` the BART-large ones (so that each file stays
near a minute on two threads).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.cli.main_both import (
    fusion_head_mask as jax_head_mask)
from garbage_classification_rca_tpu.data.images import (
    normalize_on_device as jnormalize)
from garbage_classification_rca_tpu.models.fusion import multimodal as jmm
from garbage_classification_rca_tpu.models.image import efficientnet_common as jeff
from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
from garbage_classification_rca_tpu.models.text import bart as jbart
from garbage_classification_rca_tpu.models.text import bert as jbert
from garbage_classification_rca_tpu.models.text import distilbert as jdistil
from garbage_classification_rca_tpu.train.loop import make_train_step as jstep
from garbage_classification_rca_tpu.train.optim import make_optimizer
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import export_jax_tree
from garbage_classification_rca_tpu_torch.cli import main_both as tcli
from garbage_classification_rca_tpu_torch.data.images import normalize_on_device
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.models.image import efficientnet_common as teff
from garbage_classification_rca_tpu_torch.models.text import bart as tbart
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.train.loop import make_train_step
from garbage_classification_rca_tpu_torch.train.optim import make_optimizer as \
    make_torch_optimizer
from tests.test_torch_train_step import _flatten, _numpy_leaf

torch.set_num_threads(2)


def _tables(stages, stem):
    kw = dict(stages=stages, stem_out=stem, head_out=1280, bn_eps=1e-3,
              sd_prob=0.0)
    return jeff.EffNetConfig(**kw), teff.EffNetConfig(**kw)


SHORT, SHORT_T = _tables(
    (("fused", 1, 3, 1, 8, 8, 1), ("fused", 4, 3, 2, 8, 16, 1),
     ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
     ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
     ("mb", 6, 3, 1, 32, 40, 1)), 8)
# EfficientNetV2-M's stage-3 / stage-6 widths (160, 512) with strides 1
# before stage 5: a 60x60 input gives the 30x30 stage-3 and 15x15 stage-6
# maps that 480x480 gives the full tower; the other widths narrow and no
# expansion, which XLA:CPU runs in the train step's scan 80x slower than
# outside it (a step of the depth-1 table took ~3 minutes)
HIER, HIER_T = _tables(
    (("fused", 1, 3, 1, 8, 8, 1), ("fused", 1, 3, 1, 8, 8, 1),
     ("fused", 1, 3, 1, 8, 16, 1), ("mb", 1, 3, 1, 16, 160, 1),
     ("mb", 1, 3, 1, 160, 16, 1), ("mb", 1, 3, 2, 16, 16, 1),
     ("mb", 1, 3, 1, 16, 512, 1)), 8)
BART_VOCAB = 1000
B, ACC, N = 3, 2, 16
CLASS_WEIGHTS = [0.8, 1.25, 1.0, 1.1]
LR, REG, SMOOTH = 0.05, 0.03, 0.1
TOL = 5e-5
# the JAX tree's entries each strategy reads (the JAX init builds them all)
HEAD_KEYS = {
    "MM_RCA": ("sa_img", "sa_txt", "rca_ti", "rca_it",
               "final_with_everything"),
    "gated": ("img_feats_hidden", "txt_feats_hidden", "z", "fc_gated"),
    "classic": ("image_to_hidden", "text_to_hidden", "concat", "fc"),
    "normalized": ("image_to_hidden", "text_to_hidden", "concat", "fc"),
    "clip": ("image_to_hidden", "text_to_hidden", "clip_fc", "trans_conv",
             "logit_scale"),
    "hierarchical": ("hier_img", "hier_txt", "hier_all"),
    "bimodal": ("gru_text", "gru_audio", "hadamard", "gru_bimodal",
                "concat_fc", "mod_img_to_dim", "mod_txt_to_dim",
                "bimodal_classifier"),
}
# the pairs the JAX package trains: hierarchical, bimodal and MM-RCA need
# a tower with per-layer hidden states / 768 wide, BART has neither
STRATEGIES_BY_TOWER = {
    "distilbert": tuple(HEAD_KEYS), "bert": tuple(HEAD_KEYS),
    "bart": ("gated", "classic", "normalized", "clip")}


def setting(strategy):
    """(JAX table, port table, text layers, image size) of a strategy."""
    if strategy == "hierarchical":
        return HIER, HIER_T, 4, 60
    return SHORT, SHORT_T, 2, 64


def jax_config(strategy, tower, **kw):
    kw = {"drop_ratio": 0.0, "image_or_text_dropout_chance": 0.0, **kw}
    return jmm.FusionConfig(strategy=strategy, text_model_name=tower,
                            reverse=True, batch_size=B, **kw)


def port_config(cfg):
    return tmm.FusionConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tmm.FusionConfig)})


@contextlib.contextmanager
def jax_sizes(table, layers):
    """The JAX package's module tables cut to the test's sizes (no JAX
    file changes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jeffv2.CONFIGS, "eff_v2_medium", table)
        for mod in (jdistil, jbert, jbart):
            mp.setattr(mod, "LAYERS", layers)
        mp.setattr(jbart, "VOCAB", BART_VOCAB)
        yield


@functools.lru_cache(maxsize=None)
def jax_tree(strategy, tower, seed=4):
    """(params, state): the towers and `strategy`'s heads of the JAX tree,
    numpy-filled. Cached: treat as read-only."""
    cfg = jax_config(strategy, tower)
    table, _, layers, _ = setting(strategy)
    with jax_sizes(table, layers):
        shapes = jax.eval_shape(lambda: jmm.init(jax.random.PRNGKey(4), cfg))
    rng = np.random.default_rng(seed)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(
            _numpy_leaf(path, leaf.shape, rng), np.float32), shapes)
    keep = ("text", "image") + HEAD_KEYS[strategy]
    return {k: v for k, v in params.items() if k in keep}, state


def make_stack(tower, hw, seed=5, acc=ACC, b=B):
    """[acc, b, ...] microbatches; the last one's last row padded."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, N + 1, (acc, b))
    mask = (np.arange(N)[None, None, :] < lens[..., None]).astype(np.int32)
    hi = BART_VOCAB if tower == "bart" else 30000
    valid = np.ones((acc, b), np.int32)
    valid[-1, -1] = 0
    return {
        "image": rng.integers(0, 256, (acc, b, hw, hw, 3), dtype=np.uint8),
        "input_ids": (rng.integers(3, hi, (acc, b, N)) * mask).astype(
            np.int32),
        "attention_mask": mask,
        "label": rng.integers(0, 4, (acc, b)).astype(np.int32),
        "valid": valid}


def port_model(cfg, params, state):
    """The port's FusionModel of the JAX config `cfg` holding the trees."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbart, "VOCAB", BART_VOCAB)
        return tmm.load_fusion_model(params, state, port_config(cfg),
                                     device="cpu",
                                     image_cfg=setting(cfg.strategy)[1])


@functools.lru_cache(maxsize=None)
def jax_step(strategy, tower, dtype="float32"):
    """The JAX package's train step of the pair, all trainable, images in
    `dtype`: (loss, losses, grad_norm, param_norm, {leaf: updated param},
    {leaf: BN stat})."""
    cfg = jax_config(strategy, tower)
    params, state = jax_tree(strategy, tower)
    stack = make_stack(tower, setting(strategy)[3])
    table, _, layers, _ = setting(strategy)

    def apply_fn(p, s, x, *, train=False, rng=None):
        return jmm.forward(cfg, p, s, x, train=train, rng=rng)

    def batch_to_inputs(mb):
        return (mb["input_ids"], mb["attention_mask"],
                jnormalize(mb["image"], dtype=getattr(jnp, dtype)))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    with jax_sizes(table, layers), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmm, "_drop", lambda rng, x, rate, train: x)
        step = jstep(apply_fn, make_optimizer("sgd", LR, REG),
                     class_weights=CLASS_WEIGHTS, label_smoothing=SMOOTH,
                     batch_to_inputs=batch_to_inputs, log_norms=True)
        new_p, new_s, _, loss, losses, norms = step(
            jp, jax.tree_util.tree_map(jnp.asarray, state),
            make_optimizer("sgd", LR, REG).init(jp),
            {k: jnp.asarray(v) for k, v in stack.items()},
            jax.random.PRNGKey(0))
    return (float(loss), np.asarray(losses), float(norms["grad_norm"]),
            float(norms["param_norm"]), _flatten(new_p), _flatten(new_s))


def _phase1(params, want):
    """What the JAX package's SGD step with its phase-1 mask computes, from
    its all-trainable step `want` (SGD updates each leaf from its own
    gradient and value; the frozen leaves' updates are set to zero)."""
    frozen = {k for k, v in _flatten(jax_head_mask(params)).items()
              if not v}
    before = _flatten(params)
    new_p = {k: before[k] if k in frozen else v for k, v in want[4].items()}
    norm = float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                             for v in new_p.values())))
    return want[:3] + (norm, new_p, want[5])


def _port_step(cfg, params, state, stack, trainable, dtype="float32"):
    model = port_model(cfg, params, state)
    mask = None
    if not trainable:
        mask = tcli.fusion_head_mask(model)
        assert mask == {k: bool(v) for k, v in
                        _flatten(jax_head_mask(params)).items()}
    opt = make_torch_optimizer("sgd", model.named_parameters(), LR, REG,
                               mask)

    def batch_to_inputs(mb, key):
        return (mb["input_ids"], mb["attention_mask"],
                normalize_on_device(mb["image"], dtype=getattr(torch, dtype)))

    step = make_train_step(model, opt, batch_to_inputs=batch_to_inputs,
                           class_weights=torch.tensor(CLASS_WEIGHTS),
                           label_smoothing=SMOOTH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmm, "_drop", lambda x, rate, key: x)
        loss, losses, norms = step({k: torch.from_numpy(v)
                                    for k, v in stack.items()}, Key(0))
    return (loss.item(), losses.numpy(), norms["grad_norm"].item(),
            norms["param_norm"].item(), export_jax_tree(model))


def check_train_step(strategy, tower, trainable, dtype="float32"):
    """One train step of the pair on both sides, held at 5e-5 (fp32
    images); with bf16 images at ``tests/test_torch_train_step.py``'s bf16
    bars: 2e-2 on loss and norms, 2e-3 on the updated parameters, 1e-2 on
    the BN statistics."""
    cfg = jax_config(strategy, tower)
    params, state = jax_tree(strategy, tower)
    want = jax_step(strategy, tower, dtype)
    if not trainable:
        want = _phase1(params, want)
    got = _port_step(cfg, params, state,
                     make_stack(tower, setting(strategy)[3]), trainable,
                     dtype)
    tol, ptol, stol = ((TOL,) * 3 if dtype == "float32"
                       else (2e-2, 2e-3, 1e-2))
    for g, w in zip(got[:4], want[:4]):       # loss, losses, norms
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    new_p, new_s, tree = want[4], want[5], got[4]
    stats = {k for k in tree if k.endswith((".mean", ".var"))}
    assert set(tree) - stats == set(new_p)
    assert stats == set(new_s)
    for k, v in tree.items():
        t = stol if k in stats else ptol
        np.testing.assert_allclose(v, (new_s if k in stats else new_p)[k],
                                   err_msg=k, rtol=t, atol=t)
    before = _flatten(params)
    moved = {k for k in new_p if not np.array_equal(tree[k], before[k])}
    heads = {k for k in new_p if not k.startswith(("text.", "image."))}
    if trainable:
        assert heads <= moved and any(k.startswith("text.") for k in moved)
    else:                       # phase 1: the towers kept their weights
        assert moved == heads


@pytest.mark.parametrize("trainable", [False, True], ids=["phase1", "all"])
@pytest.mark.parametrize("strategy", STRATEGIES_BY_TOWER["distilbert"])
def test_distilbert_train_step_matches_jax(strategy, trainable):
    check_train_step(strategy, "distilbert", trainable)
