"""PyTorch port, the dropout flash-attention pair on its plain versions (CPU
tensors) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs and the same keep mask.

JAX's threefry bits cannot be replayed in torch, so the JAX mask
``_drop_keep_mask(key, p, b, heads, n)`` is computed here and handed to the
port (``FixedKey``: a stand-in for ``nn.core.Key`` whose ``keep_mask`` gives
that array):

  * ``mha_fwd_lse_drop`` against ``_mha_fwd_lse_drop``: out and lse, fp32 at
    1e-5, bf16 within one bf16 ulp + 1e-3;
  * ``mha_flash_bwd_drop`` against ``_mha_flash_bwd_drop``: 5e-5 (1 + |x|) in
    fp32, one ulp + 2e-3 of the tensor's largest |x| in bf16 (the bar of the
    plain flash pair, ``tests/test_torch_train_kernels.py``);
  * ``mha_flash_train_dropout`` under autograd against ``jax.grad`` of the
    JAX ``mha_flash_train_dropout`` at 2e-4, the JAX test's own bar;
for (mask, causal) in (on, off), (on, on), (off, off). Then the contract
around the pair: lse is the no-dropout lse, the backward redraws the
forward's mask from the key, the fit rule, and the routing of
``multi_head_attention`` (p = 0 or an inactive site consumes nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import mha_fused as jmha
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
from garbage_classification_rca_tpu_torch.models.text import (
    encoder_common as tenc)
from garbage_classification_rca_tpu_torch.nn.core import HFDropout, Key

torch.set_num_threads(2)

P = 0.1
MODES = [(True, False), (True, True), (False, False)]     # (masked, causal)


class FixedKey:
    """A dropout site's key whose mask is given (the JAX draw)."""

    def __init__(self, mask):
        self.mask = torch.from_numpy(np.array(mask)).bool()
        self.draws = 0

    def keep_mask(self, shape, p, device):
        assert tuple(shape) == tuple(self.mask.shape)
        self.draws += 1
        return self.mask.clone()


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, n, d)).astype(np.float32)
                   for _ in range(4))
    lens = rng.integers(1, n + 1, b)
    lens[0] = n
    mask = (np.arange(n)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _bf16_close(got, want, rel_to_max=0.0):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(g),
                                                         np.abs(w)),
                                              2.0 ** -126))) - 7)
    tol = ulp + (rel_to_max * np.abs(w).max() if rel_to_max else 1e-3)
    assert np.all(np.abs(g - w) <= tol), float(np.abs(g - w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked,causal", MODES)
def test_dropout_pair_matches_jax_kernels(masked, causal, dtype):
    b, n, d, heads = 3, 16, 128, 4
    q, k, v, do, m = _inputs(b, n, d, seed=11 + causal)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jdm = jmha._drop_keep_mask(jax.random.PRNGKey(3), P, b, heads, n)
    tdm = torch.from_numpy(np.array(jdm))
    assert tdm.dtype == torch.uint8 and 0.7 < float(tdm.float().mean()) < 1.0
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    scale = float(1.0 / np.sqrt(d // heads))
    kw = dict(heads=heads, scale=scale, mask=jm, causal=causal, keep=1.0 - P,
              interpret=True)
    jo, jl = jmha._mha_fwd_lse_drop(jq, jk, jv, jdm, **kw)
    to, tl = K.mha_fwd_lse_drop(tq, tk, tv, tdm, heads=heads, keep=1.0 - P,
                                mask=tm, causal=causal)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert tuple(tl.shape) == (b, heads, n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    jg = jmha._mha_flash_bwd_drop(jq, jk, jv, jo, jdo, jl, jdm, **kw)
    tg = K.mha_flash_bwd_drop(tq, tk, tv, to, tdo, tl, tdm, heads=heads,
                              keep=1.0 - P, mask=tm, causal=causal)
    for j, (got, want) in enumerate(zip((to,) + tuple(tg),
                                        (jo,) + tuple(jg))):
        assert got.dtype == tdt
        if dtype == "float32":
            g, w = got.numpy(), np.asarray(want)
            tol = 1e-5 + 1e-5 * np.abs(w) if j == 0 else 5e-5 * (
                1.0 + np.abs(w))
            assert np.all(np.abs(g - w) <= tol), (j, np.abs(g - w).max())
        else:
            _bf16_close(got, want, rel_to_max=2e-3 if j else 0.0)
    assert K.mha_fwd_lse_drop.launches == 0       # CPU: the plain versions
    assert K.mha_flash_bwd_drop.launches == 0


@pytest.mark.parametrize("masked,causal", MODES)
def test_flash_train_dropout_autograd_matches_jax_grad(masked, causal):
    b, n, d, heads = 2, 12, 64, 2
    q, k, v, do, m = _inputs(b, n, d, seed=5 + causal)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    key = jax.random.PRNGKey(9)

    def loss(a, b_, c):
        o = jmha.mha_flash_train_dropout(a, b_, c, heads=heads, key=key, p=P,
                                         mask=jm, causal=causal)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, out), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                        has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    fixed = FixedKey(jmha._drop_keep_mask(key, P, b, heads, n))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = K.mha_flash_train_dropout(tq, tk, tv, heads=heads, key=fixed, p=P,
                                  mask=tm, causal=causal)
    o.backward(torch.from_numpy(do))
    assert fixed.draws == 2          # the forward's draw and the backward's
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=2e-4, atol=2e-4)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_autograd_function_matches_autograd_of_the_plain_forward():
    """The hand-written backward against torch's own differentiation of the
    plain forward, from one ``Key`` (the masks are the key's)."""
    b, n, d, heads = 2, 10, 64, 2
    q, k, v, do, m = _inputs(b, n, d, seed=21)
    tm = torch.from_numpy(m)
    key = Key(17)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    K.mha_flash_train_dropout(*a, heads=heads, key=key, p=0.5,
                              mask=tm).backward(torch.from_numpy(do))
    r = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    dm = K.drop_keep_mask(key, 0.5, b, heads, n, "cpu")
    K.mha_fwd_lse_drop_reference(*r, dm, heads=heads, keep=0.5,
                                 mask=tm)[0].backward(torch.from_numpy(do))
    for x, y in zip(a, r):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)


def test_lse_is_the_lse_without_dropout_and_a_dropped_row_gives_zeros():
    b, n, d, heads = 2, 9, 64, 2
    q, k, v, do, m = _inputs(b, n, d, seed=8)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = torch.from_numpy(m)
    tm[1] = 0                                     # a fully masked sample
    dm = K.drop_keep_mask(Key(1), 0.5, b, heads, n, "cpu")
    dm[0, 1, 3] = 0                               # a fully dropped row
    o, lse = K.mha_fwd_lse_drop(tq, tk, tv, dm, heads=heads, keep=0.5,
                                mask=tm)
    _, lse0 = K.mha_fwd_lse(tq, tk, tv, heads=heads, mask=tm)
    assert torch.equal(lse, lse0)
    assert bool((o[0, 3, 32:] == 0).all())        # head 1 of query 3
    grads = K.mha_flash_bwd_drop(tq, tk, tv, o, tdo, lse, dm, heads=heads,
                                 keep=0.5, mask=tm)
    assert all(bool(torch.isfinite(g).all()) for g in (o,) + tuple(grads))


def test_backward_redraws_the_forwards_mask(monkeypatch):
    seen = []
    real = K.drop_keep_mask

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(K, "drop_keep_mask", spy)
    q, k, v, do, m = _inputs(2, 8, 64, seed=2)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = K.mha_flash_train_dropout(*a, heads=2, key=Key(4), p=P,
                                  mask=torch.from_numpy(m))
    assert len(seen) == 1
    o.backward(torch.from_numpy(do))
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    assert seen[0].dtype == torch.uint8 and tuple(seen[0].shape) == (2, 2, 8,
                                                                     8)
    # another key, another mask
    assert not torch.equal(seen[0], real(Key(5), P, 2, 2, 8, "cpu"))


def test_flash_drop_fits_and_wrapper_checks():
    assert K.flash_drop_fits((128, 64, 768), 12, torch.float32)
    assert K.flash_drop_fits((4, 512, 768), 12, torch.bfloat16)
    assert K.flash_drop_fits((4, 197, 1024), 16, torch.bfloat16)
    assert not K.flash_drop_fits((4, 513, 768), 12, torch.float32)
    assert not K.flash_drop_fits((2, 8, 96), 2, torch.float32)     # dh 48
    assert not K.flash_drop_fits((2, 8, 64), 2, torch.float16)
    q = torch.zeros(2, 8, 64)
    with pytest.raises(TypeError, match="uint8"):
        K.mha_fwd_lse_drop(q, q, q, torch.ones(2, 2, 8, 8), heads=2,
                           keep=0.9)
    with pytest.raises(TypeError, match="uint8"):
        K.mha_fwd_lse_drop(q, q, q, torch.ones(2, 2, 8, 4,
                                               dtype=torch.uint8),
                           heads=2, keep=0.9)
    with pytest.raises(ValueError, match="keep"):
        K.mha_fwd_lse_drop(q, q, q, torch.ones(2, 2, 8, 8,
                                               dtype=torch.uint8),
                           heads=2, keep=0.0)
    with pytest.raises(ValueError, match="probability"):
        K.mha_flash_train_dropout(q, q, q, heads=2, key=Key(0), p=0.0)


def test_cpu_misfit_takes_the_plain_graph_with_the_sites_mask():
    """dh = 48 fits neither pair: on CPU tensors the plain forward under
    autograd, with the mask of the same key (on CUDA tensors it raises:
    tests/test_torch_gpu.py)."""
    q, k, v, do, m = _inputs(2, 8, 96, seed=3)
    tm = torch.from_numpy(m)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = K.mha_flash_train_dropout(*a, heads=2, key=Key(6), p=P, mask=tm)
    o.backward(torch.from_numpy(do))
    r = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    dm = K.drop_keep_mask(Key(6), P, 2, 2, 8, "cpu")
    ref = K.mha_fwd_lse_drop_reference(*r, dm, heads=2, keep=1.0 - P,
                                       mask=tm)[0]
    ref.backward(torch.from_numpy(do))
    assert torch.equal(o, ref) and torch.equal(a[0].grad, r[0].grad)


@pytest.mark.parametrize("drop,attn_p,want", [
    (None, 0.1, "plain"), ("inactive", 0.1, "plain"), ("active", 0.0,
                                                       "plain"),
    ("active", 0.1, "dropout")])
def test_attention_routing_and_site_use(monkeypatch, drop, attn_p, want):
    """Train: an active site with p > 0 takes the dropout pair and consumes
    one site; p = 0, an inactive HFDropout or none take ``mha_flash_train``
    and consume nothing."""
    calls = []
    real_plain, real_drop = tenc.mha_flash_train, tenc.mha_flash_train_dropout
    monkeypatch.setattr(tenc, "mha_flash_train", lambda *a, **kw: (
        calls.append("plain"), real_plain(*a, **kw))[1])
    monkeypatch.setattr(tenc, "mha_flash_train_dropout", lambda *a, **kw: (
        calls.append("dropout"), real_drop(*a, **kw))[1])
    d = {None: None, "inactive": HFDropout(None),
         "active": HFDropout(Key(2))}[drop]
    q, k, v, _, m = _inputs(2, 8, 64, seed=4)
    out = tenc.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(m), 2,
        train=True, drop=d, attn_p=attn_p)
    assert calls == [want] and tuple(out.shape) == (2, 8, 64)
    if d is not None:
        assert d._n == (1 if want == "dropout" else 0)
    # eval ignores the site altogether
    tenc.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(m), 2,
        train=False, drop=d, attn_p=attn_p)
    assert len(calls) == 1
