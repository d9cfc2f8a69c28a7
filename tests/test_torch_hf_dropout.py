"""PyTorch port, ``--hf_internal_dropout``: the HF text towers' own
train-mode dropout sites, against the JAX package.

Both sides consume one shared numpy mask stream (the technique of
``tests/test_hf_dropout.py``): the JAX encoders take a ``StreamDrop`` (they
only need a callable ``drop(x, p)``; without ``site_key`` their
attention-probabilities site runs on the plain graph), the port's take
``TorchStreamKeys`` with the interface of ``nn.core.HFDropout``, whose
attention site goes through ``mha_flash_train_dropout`` (its plain version
on the CPU). If a site is missing, extra, out of order, of another shape
or with another p, the two logs differ and the outputs diverge. Per
encoder (2 layers, full width, fp32): equal logs, ``1 + 2 L`` sites for
DistilBERT and ``1 + 3 L`` for BERT and RoBERTa, outputs within 1e-5.

Then the flag's contract on ``TextClassifier`` and ``FusionModel``: eval is
unchanged by the flag, train without a key is unchanged, train with the
flag and a key differs from the flag-off run and repeats for the same key,
and a flag-off run with a key draws what it drew before the flag existed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import bert as jbert
from garbage_classification_rca_tpu.models.text import distilbert as jdistil
from garbage_classification_rca_tpu.models.text import roberta as jroberta
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.models.image import (
    efficientnet_common as teff)
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text import bert as tbert
from garbage_classification_rca_tpu_torch.models.text import (
    distilbert as tdistil)
from garbage_classification_rca_tpu_torch.models.text import (
    roberta as troberta)
from garbage_classification_rca_tpu_torch.nn import core
from garbage_classification_rca_tpu_torch.nn.core import HFDropout, Key

torch.set_num_threads(2)

N_LAYERS = 2
JAX_MODS = {"distilbert": jdistil, "bert": jbert, "roberta": jroberta}
PORT_MODS = {"distilbert": tdistil, "bert": tbert, "roberta": troberta}
LAYER_OWNER = {"distilbert": jdistil, "bert": jbert, "roberta": jbert}
SITES_PER_LAYER = {"distilbert": 2, "bert": 3, "roberta": 3}


class MaskStream:
    """Deterministic Bernoulli mask sequence; logs (size, p) per call."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.log = []

    def mask(self, size, p):
        self.log.append((int(size), round(float(p), 4)))
        return (self.rng.random(int(size)) >= p).astype(np.float32)


class StreamDrop:
    """The JAX side: ``nn.HFDropout``-compatible stub on a MaskStream."""

    def __init__(self, stream):
        self.stream = stream

    def __call__(self, x, p):
        if p <= 0.0:
            return x
        m = self.stream.mask(int(np.prod(x.shape)), p).reshape(x.shape)
        return (x * jnp.asarray(m, x.dtype)) / (1.0 - p)


class TorchStreamKeys:
    """The port's side: ``HFDropout``'s interface on a MaskStream. The
    attention site's mask is read from the stream when the flash pair
    first draws it, and given again in the backward."""

    active = True

    def __init__(self, stream):
        self.stream = stream

    def __call__(self, x, p):
        if p <= 0.0:
            return x
        m = self.stream.mask(x.numel(), p).reshape(tuple(x.shape))
        return x * torch.from_numpy(m).to(x.dtype) / (1.0 - p)

    def site_key(self, p):
        if p <= 0.0:
            return None
        stream, cache = self.stream, {}

        class _Key:
            def keep_mask(self, shape, rate, device):
                if "m" not in cache:
                    cache["m"] = torch.from_numpy(stream.mask(
                        int(np.prod(shape)), rate).reshape(tuple(shape)) != 0)
                return cache["m"].clone()

        return _Key()


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@pytest.fixture(scope="module")
def jax_trees():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdistil, "LAYERS", N_LAYERS)
        mp.setattr(jbert, "LAYERS", N_LAYERS)
        for i, name in enumerate(sorted(JAX_MODS)):
            params, _ = JAX_MODS[name].init(jax.random.PRNGKey(20 + i))
            out[name] = _np_tree(params)
    return out


def _ids_mask(vocab=20000, b=2, n=12):
    rng = np.random.default_rng(7)
    lens = np.array([[n], [7]])
    mask = (np.arange(n)[None, :] < lens).astype(np.int32)
    return (rng.integers(5, vocab, (b, n)) * mask).astype(np.int32), mask


@pytest.mark.parametrize("name", sorted(JAX_MODS))
def test_encoder_sites_match_jax(name, jax_trees):
    params = jax_trees[name]
    ids, mask = _ids_mask()
    js, ts = MaskStream(31), MaskStream(31)
    jp = jax.tree_util.tree_map(jnp.asarray, params["encoder"])
    want = np.asarray(JAX_MODS[name].encode(
        jp, jnp.asarray(ids), jnp.asarray(mask), train=True,
        drop=StreamDrop(js)))
    model = get_text_model(name).load_tree(params, {}, device="cpu")
    with torch.no_grad():
        got = PORT_MODS[name].encode(
            model.encoder, torch.from_numpy(ids), torch.from_numpy(mask),
            train=True, drop=TorchStreamKeys(ts)).numpy()
    assert ts.log == js.log, f"port {ts.log}\n jax {js.log}"
    assert len(ts.log) == 1 + SITES_PER_LAYER[name] * N_LAYERS
    b, n = ids.shape
    assert ts.log[0] == (b * n * 768, 0.1)            # embeddings output
    assert ts.log[1] == (b * 12 * n * n, 0.1)         # attention probs
    keep = mask.astype(bool)       # padded queries: real, read by nothing
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-5)


def test_hf_dropout_sites_and_keys():
    x = torch.ones(4, 6)
    for d in (HFDropout(None), HFDropout(Key(1))):
        assert d.active == (d.key is not None)
        assert d(x, 0.0) is x and d.site_key(0.0) is None and d._n == 0
    off = HFDropout(None)
    assert off(x, 0.5) is x and off.site_key(0.5) is None and off._n == 0
    assert off.keep_mask((2, 2), 0.5, "cpu") is None
    a, b = HFDropout(Key(1)), HFDropout(Key(1))
    y1, y2 = a(x, 0.5), a(x, 0.5)                     # sites 1 and 2
    assert a._n == 2 and not torch.equal(y1, y2)
    assert set(y1.unique().tolist()) <= {0.0, 2.0}    # inverted dropout
    assert torch.equal(b(x, 0.5), y1)                 # same key, same site
    k = b.site_key(0.5)                               # b's site 2
    assert torch.equal(torch.where(k.keep_mask(x.shape, 0.5, "cpu"),
                                   x / 0.5, torch.zeros_like(x)), y2)
    assert torch.equal(k.keep_mask((3, 3), 0.3, "cpu"),
                       k.keep_mask((3, 3), 0.3, "cpu"))
    assert not torch.equal(HFDropout(Key(2))(x, 0.5), y1)


@pytest.mark.parametrize("name", sorted(JAX_MODS))
def test_text_classifier_flag_semantics(name, jax_trees):
    model = get_text_model(name).load_tree(jax_trees[name], {}, device="cpu")
    ids, mask = (torch.from_numpy(a) for a in _ids_mask())
    key = Key(3)
    with torch.no_grad():
        ev_off = model(ids, mask)
        ev_on = model(ids, mask, key=key, hf_internal_dropout=True)
        assert torch.equal(ev_off, ev_on)
        # train without a key: no random site at all, flag or not
        nk_off = model(ids, mask, train=True)
        nk_on = model(ids, mask, train=True, hf_internal_dropout=True)
        assert torch.equal(nk_off, nk_on)
        torch.testing.assert_close(nk_off, ev_off, rtol=1e-4, atol=1e-4)
        tr_off = model(ids, mask, train=True, key=key)
        tr_on = model(ids, mask, train=True, key=key,
                      hf_internal_dropout=True)
        tr_on2 = model(ids, mask, train=True, key=key,
                       hf_internal_dropout=True)
        tr_on3 = model(ids, mask, train=True, key=Key(4),
                       hf_internal_dropout=True)
        assert not torch.allclose(tr_off, tr_on)
        assert torch.equal(tr_on, tr_on2)
        assert not torch.equal(tr_on, tr_on3)
        # flag off with a key: the head dropout alone, drawn from the
        # unsplit key, on the pooled feature of the train-mode encoder
        pooled = PORT_MODS[name].encode(model.encoder, ids, mask,
                                        train=True)[:, 0]
        want = model.head(core.dropout(pooled, 0.6, key.generator("cpu")))
        assert torch.equal(tr_off, want)
        # flag on: the halves of the split key
        k_head, k_int = key.split(2)
        pooled = PORT_MODS[name].encode(model.encoder, ids, mask, train=True,
                                        drop=HFDropout(k_int))[:, 0]
        want = model.head(core.dropout(pooled, 0.6, k_head.generator("cpu")))
        assert torch.equal(tr_on, want)
        # drop_ratio = 0 leaves the internal sites as the only noise
        z_off = model(ids, mask, train=True, key=key, drop_ratio=0.0)
        assert torch.equal(z_off, nk_off)


SHORT = teff.EffNetConfig(
    stages=(("fused", 1, 3, 1, 8, 8, 1), ("fused", 4, 3, 2, 8, 16, 1),
            ("fused", 4, 3, 2, 16, 16, 1), ("mb", 4, 3, 2, 16, 24, 1),
            ("mb", 6, 3, 1, 24, 24, 1), ("mb", 6, 3, 2, 24, 32, 1),
            ("mb", 6, 3, 1, 32, 40, 1)),
    stem_out=8, head_out=1280, bn_eps=1e-3, sd_prob=0.0)


def test_fusion_hf_internal_dropout_flag():
    """FusionConfig.hf_internal_dropout: the train forward makes the text
    tower stochastic and leaves the image tower's stream alone; the eval
    forward is unchanged. Modality and head dropout are off."""
    kw = dict(strategy="MM_RCA", reverse=True, drop_ratio=0.0,
              image_or_text_dropout_chance=0.0)
    cfg_off = tmm.FusionConfig(**kw)
    cfg_on = dataclasses.replace(cfg_off, hf_internal_dropout=True)
    model = tmm.FusionModel(cfg_off, text_layers=1, image_cfg=SHORT,
                            generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    ids, mask = (torch.from_numpy(a) for a in _ids_mask(n=8))
    img = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    batch = (ids, mask, img)
    key = Key(5)
    with torch.no_grad():
        e_off = tmm.forward(cfg_off, model, batch)
        e_on = tmm.forward(cfg_on, model, batch)
        assert torch.equal(e_off, e_on)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        t_off = tmm.forward(cfg_off, model, batch, train=True, key=key)
        model.load_state_dict(state)              # BN running stats moved
        t_on = tmm.forward(cfg_on, model, batch, train=True, key=key)
        model.load_state_dict(state)
        t_on2 = tmm.forward(cfg_on, model, batch, train=True, key=key)
    assert not torch.allclose(t_off, t_on)
    assert torch.equal(t_on, t_on2)
    # 1 + 2 L sites of the DistilBERT tower, from fold_in(k_model, 0x4F1D)
    seen = []
    real = HFDropout.site_key

    def spy(self, p):
        k = real(self, p)
        if k is not None:           # p = 0 (no attention-output site)
            seen.append((self.key.seed, self._n))
        return k

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(HFDropout, "site_key", spy)
        tmm.forward(cfg_on, model, batch, train=True, key=key)
    k_model = key.split(3)[1]
    assert seen == [(k_model.fold_in(0x4F1D).seed, n) for n in (1, 2, 3)]
