"""PyTorch port, the training kernels on their plain versions (CPU tensors)
against the JAX package, on the same numpy weights and inputs:

  * K3 ``rca_fused_bwd`` against the Pallas ``rca_fused_bwd`` in interpret
    mode and against ``jax.vjp`` of the ``_oracle`` graph: dt, di and the
    32 weight gradients at rtol/atol 5e-5 (the JAX package's backward bar);
  * the mixed-dtype forward of K1 (t fp32 from the text tower, i bf16 from
    the image tower, as training gives them) against the Pallas
    ``rca_fused`` at 2e-5;
  * K4a ``mha_fwd_lse`` / K4b ``mha_flash_bwd`` against the Pallas
    ``_mha_fwd_lse`` / ``_mha_flash_bwd`` (interpret) and ``jax.vjp`` of
    ``mha_reference``, masked and causal: fp32 at 1e-5; bf16 outputs within
    one bf16 ulp + 1e-3, bf16 gradients within one ulp + 2e-3 of the
    tensor's largest |x| (both sides round the weights and dS to bf16 at
    the same points, but their fp32 sums are taken in another order, so a
    dS element may round to the neighbouring bf16 value and move every
    sum it enters by about its ulp times |k| or |q|);
  * the autograd wrappers ``rca_fused_trainable`` and ``mha_flash_train``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import mha_fused as jmha
from garbage_classification_rca_tpu.kernels import rca_fused as jrca
from garbage_classification_rca_tpu.ops import attention as jatt
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import load_jax_tree
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
from garbage_classification_rca_tpu_torch.kernels import rca_fused as R
from garbage_classification_rca_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

BWD_TOL = dict(rtol=5e-5, atol=5e-5)


class Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.sa_txt = tatt.AttentionUnit(48, 48, 128, 96)
        self.sa_img = tatt.AttentionUnit(80, 80, 128, 96)
        self.rca_ti = tatt.AttentionUnit(96, 96, 64, 48)
        self.rca_it = tatt.AttentionUnit(96, 96, 64, 48)


@pytest.fixture(scope="module")
def weights():
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    p = {"sa_txt": jatt.init_self_attention(ks[0], 48, 128, 96),
         "sa_img": jatt.init_self_attention(ks[1], 80, 128, 96),
         "rca_ti": jatt.init_cross_attention(ks[2], 96, 96, 64, 48),
         "rca_it": jatt.init_cross_attention(ks[3], 96, 96, 64, 48)}
    rng = np.random.default_rng(5)
    for u in p.values():   # non-trivial LayerNorm affine
        u["norm"]["scale"] = jnp.asarray(
            rng.uniform(0.5, 1.5, u["norm"]["scale"].shape).astype(np.float32))
        u["norm"]["bias"] = jnp.asarray(
            rng.uniform(-0.5, 0.5, u["norm"]["bias"].shape).astype(np.float32))
    block, _ = load_jax_tree(Block(), jax.tree_util.tree_map(np.asarray, p))
    return p, block


def _rca_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, 16, 48), (b, 16, 80), (b, 16, 48), (b, 16, 48))]


def _torch_layout(jax_grads):
    """The JAX tree's 32 gradients in kernel order, in torch layouts."""
    return [np.asarray(g).T if np.ndim(g) == 2 else np.asarray(g)
            for g in jrca._weights(jax_grads)]


def _check_grads(got, want_dt, want_di, want_w, di_tol=BWD_TOL):
    dt, di, dw = got
    np.testing.assert_allclose(dt.float().numpy(), np.asarray(want_dt),
                               **BWD_TOL)
    np.testing.assert_allclose(di.float().numpy(),
                               np.asarray(want_di, np.float32), **di_tol)
    assert len(dw) == 32
    for g, w in zip(dw, want_w):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **BWD_TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch", [8, 13])
def test_rca_bwd_matches_jax_kernel_and_vjp(weights, batch, reverse):
    p, block = weights
    t, i, g_ti, g_it = _rca_inputs(batch, seed=batch)
    got = R.rca_fused_bwd(block, *(torch.from_numpy(a)
                                   for a in (t, i, g_ti, g_it)),
                          reverse=reverse)
    dp, dt, di = jrca.rca_fused_bwd(p, *(jnp.asarray(a)
                                         for a in (t, i, g_ti, g_it)),
                                    reverse=reverse, interpret=True)
    _check_grads(got, dt, di, _torch_layout(dp))
    _, vjp = jax.vjp(lambda p_, t_, i_: jrca._oracle(p_, t_, i_, reverse),
                     p, jnp.asarray(t), jnp.asarray(i))
    dp, dt, di = vjp((jnp.asarray(g_ti), jnp.asarray(g_it)))
    _check_grads(got, dt, di, _torch_layout(dp))
    assert R.rca_fused_bwd.launches == 0      # CPU tensors: plain version


def test_rca_mixed_dtype_forward_matches_jax(weights):
    """t fp32 and i bf16, the training path's inputs: each read as fp32,
    outputs in t's dtype (the port used to raise a TypeError here)."""
    p, block = weights
    t, i, _, _ = _rca_inputs(6, seed=21)
    want = jrca.rca_fused(p, jnp.asarray(t), jnp.asarray(i, jnp.bfloat16),
                          reverse=True, interpret=True)
    got = R.rca_fused(block, torch.from_numpy(t),
                      torch.from_numpy(i).to(torch.bfloat16), reverse=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=2e-5, atol=2e-5)


def test_rca_mixed_dtype_backward_matches_jax_vjp(weights):
    """The backward of the mixed input: di comes out in bf16 (i's dtype),
    within one bf16 ulp of the fp32 gradient; the rest at 5e-5."""
    p, block = weights
    t, i, g_ti, g_it = _rca_inputs(5, seed=22)
    i16 = torch.from_numpy(i).to(torch.bfloat16)
    got = R.rca_fused_bwd(block, torch.from_numpy(t), i16,
                          torch.from_numpy(g_ti), torch.from_numpy(g_it),
                          reverse=True)
    assert got[1].dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda p_, t_, i_: jrca._oracle(p_, t_, i_, True), p,
                     jnp.asarray(t), jnp.asarray(i16.float().numpy()))
    dp, dt, di = vjp((jnp.asarray(g_ti), jnp.asarray(g_it)))
    _check_grads(got, dt, di, _torch_layout(dp),
                 di_tol=dict(rtol=2 ** -8, atol=1e-4))


def test_rca_fused_trainable_autograd_matches_jax_vjp(weights):
    p, block = weights
    t, i, g_ti, g_it = _rca_inputs(4, seed=23)
    tt = torch.from_numpy(t).requires_grad_()
    ii = torch.from_numpy(i).requires_grad_()
    block.zero_grad()
    ti, it = R.rca_fused_trainable(block, tt, ii, reverse=True)
    (ti * torch.from_numpy(g_ti) + it * torch.from_numpy(g_it)).sum().backward()
    _, vjp = jax.vjp(lambda p_, t_, i_: jrca._oracle(p_, t_, i_, True), p,
                     jnp.asarray(t), jnp.asarray(i))
    dp, dt, di = vjp((jnp.asarray(g_ti), jnp.asarray(g_it)))
    _check_grads((tt.grad, ii.grad, [w.grad for w in R._weights(block)]),
                 dt, di, _torch_layout(dp))


# ---------------------------------------------------------------------------
# K4a / K4b
# ---------------------------------------------------------------------------


def _mha_inputs(b, n, d, seed):
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


CASES = [(3, 16, 64, 4, True, False), (2, 12, 64, 2, True, True),
         (2, 64, 768, 12, True, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d,heads,masked,causal", CASES)
def test_mha_train_pair_matches_jax_kernels(b, n, d, heads, masked, causal,
                                            dtype):
    q, k, v, do, m = _mha_inputs(b, n, d, seed=b * n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    scale = float(1.0 / np.sqrt(d // heads))
    jo, jl = jmha._mha_fwd_lse(jq, jk, jv, heads=heads, scale=scale, mask=jm,
                               causal=causal, interpret=True)
    to, tl = K.mha_fwd_lse(tq, tk, tv, heads=heads, mask=tm, causal=causal)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert tuple(tl.shape) == (b, heads, n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    jg = jmha._mha_flash_bwd(jq, jk, jv, jo, jdo, jl, heads=heads,
                             scale=scale, mask=jm, causal=causal,
                             interpret=True)
    tg = K.mha_flash_bwd(tq, tk, tv, to, tdo, tl, heads=heads, mask=tm,
                         causal=causal)
    for j, (got, want) in enumerate(zip((to,) + tuple(tg),
                                        (jo,) + tuple(jg))):
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        else:
            _bf16_close(got, want, rel_to_max=2e-3 if j else 0.0)
    assert K.mha_fwd_lse.launches == 0 and K.mha_flash_bwd.launches == 0


@pytest.mark.parametrize("b,n,d,heads,masked,causal", CASES[:2])
def test_mha_flash_train_autograd_matches_jax_vjp(b, n, d, heads, masked,
                                                  causal):
    """fp32: ``mha_flash_train`` under autograd against ``jax.vjp`` of the
    JAX ``mha_reference`` graph."""
    q, k, v, do, m = _mha_inputs(b, n, d, seed=7 + n)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    out, vjp = jax.vjp(lambda a, b_, c: jmha.mha_reference(
        a, b_, c, heads=heads, mask=jm, causal=causal),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = K.mha_flash_train(tq, tk, tv, heads=heads, mask=tm, causal=causal)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_train_fits_and_misfit_route():
    assert K.flash_train_fits((16, 64, 768), 12, torch.float32)
    assert K.flash_train_fits((4, 512, 768), 12, torch.bfloat16)
    assert not K.flash_train_fits((4, 513, 768), 12, torch.float32)
    assert not K.flash_train_fits((2, 8, 96), 2, torch.float32)   # dh 48
    # on CPU tensors a misfit goes through mha_reference under autograd
    # (on CUDA tensors it raises: tests/test_torch_gpu.py)
    q, k, v, do, m = _mha_inputs(2, 8, 96, seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = K.mha_flash_train(tq, tk, tv, heads=2, mask=torch.from_numpy(m))
    o.backward(torch.from_numpy(do))
    rq, rk, rv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    r = K.mha_reference(rq, rk, rv, heads=2, mask=torch.from_numpy(m))
    r.backward(torch.from_numpy(do))
    assert torch.equal(o, r) and torch.equal(tq.grad, rq.grad)
