"""PyTorch port, the train step as a whole: the port's ``make_train_step``
against the JAX package's ``make_train_step`` on the same weights (numpy
values in the JAX trees, loaded through ``checkpoint/from_jax``), the same
microbatch stack and
the same optimizer (SGD, weight decay, class weights, label smoothing).

The short 7-stage EfficientNet table of ``tests/test_torch_slice.py`` with
``sd_prob=0``, DistilBERT cut to 2 layers, ``drop_ratio=0``, no modality
dropout and no augmentation, so that no random draw is taken. The stack is
two microbatches of 3 (the second with a padded tail) and a third,
fully padded one (valid = 0), as ``stacked_batches`` pads an epoch's end.
In fp32: loss, per-microbatch losses, grad_norm, param_norm, every updated
parameter and every BN running stat within 5e-5, with the phase-1 mask
(towers frozen in the optimizer, every gradient still taken) and all
trainable. With bf16 images and fp32 master weights (the recipe's dtypes:
the image tower runs in bf16, the text tower in fp32, the RCA kernel gets
both): 2e-2 on loss and norms, 2e-3 on the updated parameters and 1e-2
on the BN running stats (batch statistics of bf16 activations, which the
two frameworks' bf16 convolutions round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.cli.main_both import fusion_head_mask
from garbage_classification_rca_tpu.data.images import (
    normalize_on_device as jnormalize)
from garbage_classification_rca_tpu.models.fusion import multimodal as jmm
from garbage_classification_rca_tpu.models.image import efficientnet_common as jeff
from garbage_classification_rca_tpu.models.image import efficientnet_v2 as jeffv2
from garbage_classification_rca_tpu.train.loop import make_train_step as jstep
from garbage_classification_rca_tpu.train.optim import make_optimizer
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import export_jax_tree
from garbage_classification_rca_tpu_torch.cli import main_both as tcli
from garbage_classification_rca_tpu_torch.data.images import normalize_on_device
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.models.image import efficientnet_common as teff
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.train.loop import make_train_step
from garbage_classification_rca_tpu_torch.train.optim import make_optimizer as \
    make_torch_optimizer

torch.set_num_threads(2)

SHORT = jeff.EffNetConfig(
    stages=(("fused", 1, 3, 1, 8, 8, 1), ("fused", 4, 3, 2, 8, 16, 1),
            ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
            ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
            ("mb", 6, 3, 1, 32, 40, 1)),
    stem_out=8, head_out=1280, bn_eps=1e-3, sd_prob=0.0)
SHORT_T = teff.EffNetConfig(stages=SHORT.stages, stem_out=SHORT.stem_out,
                            head_out=SHORT.head_out, bn_eps=SHORT.bn_eps,
                            sd_prob=0.0)
PORTED = ("text", "image", "sa_img", "sa_txt", "rca_ti", "rca_it",
          "final_with_everything")
CLASS_WEIGHTS = [0.8, 1.25, 1.0, 1.1]
LR, REG, SMOOTH = 0.05, 0.03, 0.1


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for j, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{j}."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _numpy_leaf(path, shape, rng):
    """A value for one leaf of the JAX tree, drawn with numpy: fan-in
    uniform weights, small biases, non-trivial norm affines and stats."""
    name = str(path[-1].key) if hasattr(path[-1], "key") else ""
    parent = str(getattr(path[-2], "key", "")) if len(path) > 1 else ""
    if name == "w" and parent in ("word_emb", "pos_emb"):
        return rng.normal(0.0, 0.02, shape)
    if name == "w":
        fan_in = int(np.prod(shape[:-1]))
        return rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
    if name == "scale":
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return rng.normal(0.0, 0.2, shape)
    if name == "var":
        return rng.uniform(0.5, 2.0, shape)
    return rng.uniform(-0.2, 0.2, shape)           # b, bias


@pytest.fixture(scope="module")
def setup():
    """The JAX trees' structure from ``jax.eval_shape`` of the JAX init
    (no arrays drawn), filled with numpy values."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
        cfg = jmm.FusionConfig(strategy="MM_RCA", reverse=True,
                               drop_ratio=0.0,
                               image_or_text_dropout_chance=0.0)
        shapes = jax.eval_shape(lambda: jmm.init(jax.random.PRNGKey(4), cfg))
    rng = np.random.default_rng(4)
    params, state = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _numpy_leaf(path, leaf.shape, rng).astype(
            np.float32), shapes)
    params = {k: v for k, v in params.items() if k in PORTED}
    params["text"]["layers"] = params["text"]["layers"][:2]
    rng = np.random.default_rng(5)
    acc, b, n = 3, 3, 16
    lens = rng.integers(3, n + 1, (acc, b))
    mask = (np.arange(n)[None, None, :] < lens[..., None]).astype(np.int32)
    stack = {
        "image": rng.integers(0, 256, (acc, b, 64, 64, 3), dtype=np.uint8),
        "input_ids": (rng.integers(1000, 30000, (acc, b, n)) * mask).astype(
            np.int32),
        "attention_mask": mask,
        "label": rng.integers(0, 4, (acc, b)).astype(np.int32),
        "valid": np.array([[1, 1, 1], [1, 1, 0], [0, 0, 0]], np.int32)}
    return cfg, params, state, stack


def _jax_step(cfg, params, state, stack, trainable, dtype):
    def apply_fn(p, s, x, *, train=False, rng=None):
        return jmm.forward(cfg, p, s, x, train=train, rng=rng)

    def batch_to_inputs(mb):
        return (mb["input_ids"], mb["attention_mask"],
                jnormalize(mb["image"], dtype=dtype))

    mask = fusion_head_mask(params) if not trainable else None
    step = jstep(apply_fn, make_optimizer("sgd", LR, REG, mask),
                 class_weights=CLASS_WEIGHTS, label_smoothing=SMOOTH,
                 batch_to_inputs=batch_to_inputs, log_norms=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = make_optimizer("sgd", LR, REG, mask).init(jp)
    new_p, new_s, _, loss, losses, norms = step(
        jp, jax.tree_util.tree_map(jnp.asarray, state), opt_state,
        {k: jnp.asarray(v) for k, v in stack.items()},
        jax.random.PRNGKey(0))
    return (float(loss), np.asarray(losses), float(norms["grad_norm"]),
            float(norms["param_norm"]), _flatten(new_p), _flatten(new_s))


def _port_step(cfg, params, state, stack, trainable, dtype):
    tcfg = tmm.FusionConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tmm.FusionConfig)})
    model = tmm.load_fusion_model(params, state, tcfg, device="cpu",
                                  image_cfg=SHORT_T)
    opt = make_torch_optimizer(
        "sgd", model.named_parameters(), LR, REG,
        None if trainable else tcli.fusion_head_mask(model))

    def batch_to_inputs(mb, key):
        return (mb["input_ids"], mb["attention_mask"],
                normalize_on_device(mb["image"], dtype=dtype))

    step = make_train_step(model, opt, batch_to_inputs=batch_to_inputs,
                           class_weights=torch.tensor(CLASS_WEIGHTS),
                           label_smoothing=SMOOTH)
    loss, losses, norms = step({k: torch.from_numpy(v)
                                for k, v in stack.items()}, Key(0))
    return (loss.item(), losses.numpy(), norms["grad_norm"].item(),
            norms["param_norm"].item(), export_jax_tree(model))


@pytest.mark.parametrize("trainable,dtype,tol,ptol,stol", [
    (False, "float32", 5e-5, 5e-5, 5e-5),
    (True, "float32", 5e-5, 5e-5, 5e-5),
    (True, "bfloat16", 2e-2, 2e-3, 1e-2)])
def test_train_step_matches_jax(setup, monkeypatch, trainable, dtype, tol,
                                ptol, stol):
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
    cfg, params, state, stack = setup
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _jax_step(cfg, params, state, stack, trainable, jdt)
    got = _port_step(cfg, params, state, stack, trainable, tdt)
    close = dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(got[0], want[0], **close)          # loss
    np.testing.assert_allclose(got[1], want[1], **close)          # losses
    assert got[1][2] == 0.0                       # the padded microbatch
    np.testing.assert_allclose(got[2], want[2], **close)          # grad_norm
    np.testing.assert_allclose(got[3], want[3], **close)          # param_norm
    new_p, new_s = want[4], want[5]
    tree = got[4]
    stats = {k for k in tree if k.endswith((".mean", ".var"))}
    assert set(tree) - stats == set(new_p)
    assert stats == set(new_s)
    for k, v in tree.items():
        w, t = (new_s[k], stol) if k in stats else (new_p[k], ptol)
        np.testing.assert_allclose(v, w, rtol=t, atol=t, err_msg=k)
    if not trainable:     # phase 1: the towers kept their weights
        before = _flatten(params)
        for k in new_p:
            if k.startswith(("text.", "image.")):
                np.testing.assert_array_equal(tree[k], before[k])
