"""PyTorch port, the late-fusion heads' train-mode dropout and the gates of
modality dropout, against the JAX package.

  * Every head's dropout sites, with the DistilBERT and the BERT tower:
    the JAX forward's ``_drop`` and the port's ``core.dropout`` each made
    a reader of one shared numpy mask stream (``MaskStream``, the
    technique of ``tests/test_torch_hf_dropout.py``), ``drop_ratio`` 0.6,
    no modality dropout, stochastic depth 0. Equal site logs (gated,
    classic, normalized, MM-RCA one site at 0.6; hierarchical two, on
    its image and text concatenations; bimodal two at 0.86, on the fused
    GRU output and the projection; clip none) and train-mode logits within
    1e-4.
  * bf16 images over the fp32 text tower and weights (the recipe's
    dtypes): gated's gate and CLIP's similarity logits compute in the
    dtype the JAX head's arrays promote to; one train step of each against
    the JAX step at ``tests/test_torch_train_step.py``'s bf16 bars. The
    JAX bimodal head cannot take that step (its GRU's scan carry starts in
    the rows' bf16 and the cell's ``x @ w_ih`` promotes it to fp32: a
    TypeError); the port's GRU runs such rows in fp32, the dtype the JAX
    cell computes in.
  * A hierarchical batch whose image (text) the modality dropout drops:
    every image-tower (text-tower) gradient exactly zero, on both sides —
    the gate covers the stage maps and the hidden states the head reads,
    not only the pooled features — while the other tower's are not.

The tables and trees are those of ``tests/test_torch_fusion_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.fusion import multimodal as jmm
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.core import Key
from tests.test_torch_fusion_train import (HEAD_KEYS, check_train_step,
                                           jax_config, jax_sizes, jax_step,
                                           jax_tree, make_stack, port_model,
                                           setting)
from tests.test_torch_hf_dropout import MaskStream, StreamDrop, TorchStreamKeys

torch.set_num_threads(2)

# (rate, sites) of each head's train-mode dropout
SITES = {"MM_RCA": (0.6, 1), "gated": (0.6, 1), "classic": (0.6, 1),
         "normalized": (0.6, 1), "clip": (0.6, 0), "hierarchical": (0.6, 2),
         "bimodal": (0.86, 2)}


def _batch(strategy, tower):
    stack = make_stack(tower, setting(strategy)[3], seed=6)
    return tuple(stack[k][0] for k in ("input_ids", "attention_mask",
                                       "image"))


def _normalized(images):
    from garbage_classification_rca_tpu_torch.data.images import (
        normalize_on_device)

    return normalize_on_device(torch.from_numpy(images), dtype=torch.float32)


def _jax_inputs(batch):
    from garbage_classification_rca_tpu.data.images import (
        normalize_on_device as jnormalize)

    ids, mask, images = batch
    return (jnp.asarray(ids), jnp.asarray(mask),
            jnormalize(jnp.asarray(images), dtype=jnp.float32))


@pytest.mark.parametrize("tower", ["distilbert", "bert"])
@pytest.mark.parametrize("strategy", tuple(HEAD_KEYS))
def test_head_dropout_sites_match_jax(strategy, tower, monkeypatch):
    cfg = jax_config(strategy, tower, drop_ratio=0.6)
    params, state = jax_tree(strategy, tower)
    batch = _batch(strategy, tower)
    table, _, layers, _ = setting(strategy)
    js, ts = MaskStream(51), MaskStream(51)

    def jax_drop(rng, x, rate, train):
        return StreamDrop(js)(x, rate) if train and rng is not None else x

    with jax_sizes(table, layers):
        monkeypatch.setattr(jmm, "_drop", jax_drop)
        fwd = jax.jit(lambda p, s, x: jmm.forward(
            cfg, p, s, x, train=True, rng=jax.random.PRNGKey(0))[0])
        want = np.asarray(fwd(jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, state),
                              _jax_inputs(batch)))
    model = port_model(cfg, params, state)
    real = tcore.dropout

    def port_drop(x, rate, generator):
        assert generator is not None          # a train-mode site
        return TorchStreamKeys(ts)(x, rate)

    monkeypatch.setattr(tcore, "dropout", port_drop)
    ids, mask, images = batch
    with torch.no_grad():
        got = tmm.forward(model.cfg, model, (torch.from_numpy(ids),
                                             torch.from_numpy(mask),
                                             _normalized(images)),
                          train=True, key=Key(0)).numpy()
    monkeypatch.setattr(tcore, "dropout", real)
    rate, n = SITES[strategy]
    assert ts.log == js.log, f"port {ts.log}\n jax {js.log}"
    assert [p for _, p in ts.log] == [rate] * n
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _zero(grads, prefix):
    return all(not np.any(g) for k, g in grads.items()
               if k.startswith(prefix))


@pytest.mark.parametrize("tower", ["distilbert", "bert"])
@pytest.mark.parametrize("dropped", ["image", "text"])
def test_dropped_tower_gets_no_gradient(dropped, tower):
    """u1 < 1 always drops a modality; img_prob_dropout 1 (0) makes it the
    image (the text)."""
    strategy = "hierarchical"
    cfg = jax_config(strategy, tower, image_or_text_dropout_chance=1.0,
                     img_prob_dropout=1.0 if dropped == "image" else 0.0)
    params, state = jax_tree(strategy, tower)
    batch = _batch(strategy, tower)
    table, _, layers, _ = setting(strategy)
    other = "text" if dropped == "image" else "image"

    def loss(p):
        out, _ = jmm.forward(cfg, p, jax.tree_util.tree_map(
            jnp.asarray, state), _jax_inputs(batch), train=True,
            rng=jax.random.PRNGKey(1))
        return jnp.sum(out * jnp.arange(1.0, 5.0))

    with jax_sizes(table, layers):
        g = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray,
                                                           params))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(g)}
    assert _zero(flat, dropped) and not _zero(flat, other)

    model = port_model(cfg, params, state)
    ids, mask, images = batch
    with torch.enable_grad():
        out = tmm.forward(model.cfg, model, (torch.from_numpy(ids),
                                             torch.from_numpy(mask),
                                             _normalized(images)),
                          train=True, key=Key(1))
        (out * torch.arange(1.0, 5.0)).sum().backward()
    grads = {n: np.zeros(1) if p.grad is None else p.grad.numpy()
             for n, p in model.named_parameters()}
    assert _zero(grads, dropped + ".") and not _zero(grads, other + ".")
    assert all(np.isfinite(v).all() for v in grads.values())


@pytest.mark.parametrize("strategy", ["gated", "clip"])
def test_bf16_images_train_step_matches_jax(strategy):
    check_train_step(strategy, "distilbert", True, "bfloat16")


def test_bimodal_bf16_images_run_in_the_promoted_dtype():
    from garbage_classification_rca_tpu_torch.nn.core import GRU

    with pytest.raises(TypeError, match="carry"):
        jax_step("bimodal", "distilbert", "bfloat16")
    gru = GRU(6, 5, generator=torch.Generator().manual_seed(2))
    x = torch.randn(7, 6, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = gru(x.to(torch.bfloat16))
        want = gru(x.to(torch.bfloat16).float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
