"""PyTorch port, kernel K1 (fused MM-RCA block): the port's ``rca_fused``
(its plain version on the CPU) and ``ops.attention`` against the JAX
package's Pallas ``rca_fused`` in interpret mode and its ``ops.attention``,
on the same numpy weights and inputs. fp32, rtol/atol 2e-5 — the JAX
package's own bar for this kernel (tests/test_rca_kernel.py)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels.rca_fused import rca_fused as jax_rca
from garbage_classification_rca_tpu.ops import attention as jatt
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import load_jax_tree
from garbage_classification_rca_tpu_torch.kernels import rca_fused as K
from garbage_classification_rca_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


TOL = dict(rtol=2e-5, atol=2e-5)


class Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.sa_txt = tatt.AttentionUnit(48, 48, 128, 96)
        self.sa_img = tatt.AttentionUnit(80, 80, 128, 96)
        self.rca_ti = tatt.AttentionUnit(96, 96, 64, 48)
        self.rca_it = tatt.AttentionUnit(96, 96, 64, 48)


@pytest.fixture(scope="module")
def weights():
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    p = {"sa_txt": jatt.init_self_attention(ks[0], 48, 128, 96),
         "sa_img": jatt.init_self_attention(ks[1], 80, 128, 96),
         "rca_ti": jatt.init_cross_attention(ks[2], 96, 96, 64, 48),
         "rca_it": jatt.init_cross_attention(ks[3], 96, 96, 64, 48)}
    rng = np.random.default_rng(7)
    for u in p.values():   # non-trivial LayerNorm affine
        u["norm"]["scale"] = jnp.asarray(
            rng.uniform(0.5, 1.5, u["norm"]["scale"].shape).astype(np.float32))
        u["norm"]["bias"] = jnp.asarray(
            rng.uniform(-0.5, 0.5, u["norm"]["bias"].shape).astype(np.float32))
    block, _ = load_jax_tree(Block(), jax.tree_util.tree_map(np.asarray, p))
    return p, block


def _inputs(b, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 16, 48)).astype(np.float32),
            rng.normal(size=(b, 16, 80)).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch", [8, 13])
def test_rca_fused_matches_jax_kernel(weights, batch, reverse):
    p, block = weights
    t, i = _inputs(batch)
    want = jax_rca(p, jnp.asarray(t), jnp.asarray(i), reverse=reverse,
                   interpret=True)
    got = K.rca_fused(block, torch.from_numpy(t), torch.from_numpy(i),
                      reverse=reverse)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (batch, 16, 48)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert K.rca_fused.launches == 0      # CPU tensors: plain version


@pytest.mark.parametrize("reverse", [False, True])
def test_attention_units_match_jax_ops(weights, reverse):
    p, block = weights
    t, i = _inputs(5, seed=2)
    jt, ji = jnp.asarray(t), jnp.asarray(i)
    tt, ti = torch.from_numpy(t), torch.from_numpy(i)
    j_tsa = jatt.self_attention(p["sa_txt"], jt)
    j_isa = jatt.self_attention(p["sa_img"], ji)
    t_tsa = tatt.self_attention(block.sa_txt, tt)
    t_isa = tatt.self_attention(block.sa_img, ti)
    np.testing.assert_allclose(t_tsa.numpy(), np.asarray(j_tsa),
                               **TOL)
    np.testing.assert_allclose(t_isa.numpy(), np.asarray(j_isa),
                               **TOL)
    j_out = jatt.reverse_cross_attention(p["rca_ti"], j_tsa, j_isa, reverse)
    t_out = tatt.reverse_cross_attention(block.rca_ti, t_tsa, t_isa, reverse)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               **TOL)


def test_reverse_cross_attention_rejects_non_square(weights):
    _, block = weights
    with pytest.raises(ValueError, match="square"):
        tatt.reverse_cross_attention(block.rca_ti, torch.zeros(2, 16, 96),
                                     torch.zeros(2, 8, 96), True)


def test_rca_fused_checks_its_arguments(weights):
    _, block = weights
    t, i = (torch.from_numpy(a) for a in _inputs(2))
    with pytest.raises(ValueError):
        K.rca_fused(block, t[:, :8], i, reverse=True)
    with pytest.raises(ValueError):
        K.rca_fused(block, t, i[:1], reverse=True)
    with pytest.raises(TypeError):
        K.rca_fused(block, t.double(), i.double(), reverse=True)
    bad = types.SimpleNamespace(sa_txt=block.sa_img, sa_img=block.sa_img,
                                rca_ti=block.rca_ti, rca_it=block.rca_it)
    with pytest.raises(ValueError, match="sa_txt"):
        K.rca_fused(bad, t, i, reverse=True)


def test_rca_fused_bf16_plain_computes_in_fp32(weights):
    """bf16 inputs: the plain version computes in fp32 and rounds once at
    the output, as the kernel does (the JAX kernel promotes the same way)."""
    p, block = weights
    t, i = _inputs(4, seed=3)
    tb, ib = (torch.from_numpy(a).bfloat16() for a in (t, i))
    got = K.rca_fused(block, tb, ib, reverse=True)
    want = jax_rca(p, jnp.asarray(tb.float().numpy()),
                   jnp.asarray(ib.float().numpy()), reverse=True,
                   interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(
            g.float().numpy(),
            torch.from_numpy(np.array(w)).bfloat16().float().numpy(),
            rtol=2 ** -7, atol=1e-5)
