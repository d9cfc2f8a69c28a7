"""PyTorch port, kernel K2 (masked / causal multi-head attention): the
port's ``mha`` (its plain version on the CPU) against the JAX package's
Pallas ``mha`` in interpret mode and its ``mha_reference``, on the same
numpy inputs. fp32: atol 1e-5 (rtol 1e-5). One bf16 case holds the
rounding of the softmax weights to V's dtype before the PV product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels.mha_fused import mha as jax_mha
from garbage_classification_rca_tpu.kernels.mha_fused import (
    mha_reference as jax_mha_reference)
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


RNG = np.random.default_rng(11)


def _qkv(b, n, d, dtype=np.float32):
    return [RNG.normal(size=(b, n, d)).astype(dtype) for _ in range(3)]


def _mask(b, n):
    lens = RNG.integers(1, n + 1, b)
    lens[0] = n
    return (np.arange(n)[None, :] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("b,n,heads,dh,masked,causal", [
    (3, 16, 4, 16, True, False),      # padded key rows
    (2, 12, 2, 32, True, True),       # causal + key mask
    (2, 10, 3, 8, False, True),       # causal alone
    (5, 24, 2, 32, True, False),      # batch no tile divides
    (2, 64, 12, 64, True, False),     # the DistilBERT layer geometry
])
def test_mha_matches_jax(b, n, heads, dh, masked, causal):
    q, k, v = _qkv(b, n, heads * dh)
    m = _mask(b, n) if masked else None
    jm = jnp.asarray(m) if masked else None
    got = K.mha(*(torch.from_numpy(a) for a in (q, k, v)), heads=heads,
                mask=torch.from_numpy(m) if masked else None, causal=causal)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), heads=heads,
                   mask=jm, causal=causal, interpret=True)
    ref = jax_mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                            heads=heads, mask=jm, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert K.mha.launches == 0        # CPU tensors: plain version


def test_mha_bf16_rounds_weights_before_pv():
    """bf16: the fp32 softmax weights are rounded to bf16 before the PV
    product, as in JAX's mha_reference; agreement within one bf16 ulp of
    the output plus 1e-3 for weights landing on the other neighbour."""
    b, n, heads, dh = 2, 32, 4, 16
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(b, n, heads * dh))
    m = torch.from_numpy(_mask(b, n))
    got = K.mha(q, k, v, heads=heads, mask=m).float().numpy()
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_mha_reference(*j, heads=heads, mask=jnp.asarray(
        m.numpy())).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-3)
    # the same math without the rounding of the weights is measurably off
    s = (q.float().reshape(b, n, heads, dh).transpose(1, 2)
         @ k.float().reshape(b, n, heads, dh).transpose(1, 2).transpose(-1, -2))
    s = s / dh ** 0.5 + ((m.float() - 1) * 1e30)[:, None, None, :]
    unrounded = (torch.softmax(s, -1) @ v.float().reshape(
        b, n, heads, dh).transpose(1, 2)).transpose(1, 2).reshape(b, n, -1)
    assert np.abs(unrounded.numpy() - got).max() > 0


def test_mha_checks_its_arguments():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="divisible"):
        K.mha(q, q, q, heads=5)
    with pytest.raises(TypeError, match="mask"):
        K.mha(q, q, q, heads=4, mask=torch.ones(2, 8, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.mha(q, q, q[:, :4], heads=4)
    long = torch.zeros(1, K.MAX_N + 1, 64)
    with pytest.raises(ValueError, match="N <="):
        K.mha(long, long, long, heads=4)
