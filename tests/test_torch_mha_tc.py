"""PyTorch port, the flash pair's launch plan and its plain versions at the
lengths of the tensor-core route (CPU tensors; the kernels themselves run
on the card: ``tests/test_torch_gpu.py``):

  * ``flash_plan``: bf16 at head dim 64 and 1 <= N <= 256 goes to the
    tensor-core route ("tc"; np = N rounded up to 16, a block per (head,
    sample) in the forward and in the two backward kernels, shared memory
    within the H100's 227 KB, two blocks to an SM); fp32, longer
    N and other head dims go to the CUDA-core kernels; head dims the
    kernels are not built for are refused;
  * the plain pair ``mha_fwd_lse_reference`` / ``mha_flash_bwd_reference``
    (what the wrappers run on the CPU and what the card's kernels are held
    to) against the Pallas ``_mha_fwd_lse`` / ``_mha_flash_bwd`` in
    interpret mode at those lengths: bf16 N = 197 unmasked and key-masked,
    N = 65 causal, and a fully masked sample. Tolerances as the bf16 cases
    of ``tests/test_torch_train_kernels.py``: lse 1e-5; the output within
    one bf16 ulp + 1e-3; gradients within one ulp + 2e-3 of the tensor's
    largest |x| (both sides round at the same points and sum in another
    order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import mha_fused as jmha
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
from garbage_classification_rca_tpu_torch.kernels.transformer_block import (
    MAX_SMEM)

torch.set_num_threads(2)

BF16 = torch.bfloat16


@pytest.mark.parametrize("n", [1, 17, 64, 65, 197, 256])
def test_flash_plan_takes_bf16_head_dim_64_up_to_256_on_the_tensor_cores(n):
    plan = K.flash_plan((128, n, 768), 12, BF16)
    tiles = -(-n // 64)
    assert plan.route == "tc"
    assert plan.np == -(-n // 16) * 16 and plan.np % 16 == 0
    assert plan.np >= n and plan.np - n < 16
    assert plan.grid_fwd == plan.grid_dq == plan.grid_dkdv == (12, 128, 1)
    assert plan.smem_fwd == 3 * tiles * 8192 + 256 * 4 + 16 + 1024
    for smem in (plan.smem_fwd, plan.smem_dq, plan.smem_dkdv):
        assert 0 < smem <= MAX_SMEM


def test_flash_plan_of_the_vit_b16_train_shape():
    plan = K.flash_plan((128, 197, 768), 12, BF16)
    assert (plan.route, plan.np) == ("tc", 208)
    # K, V and the four query tiles of one head in the forward; one side's
    # four tiles and two stages of the other side's in the backward kernels
    assert plan.smem_fwd == 3 * 4 * 8192 + 256 * 4 + 16 + 1024
    assert plan.smem_dq == 12 * 8192 + 256 * 4 + 64 * 4 + 6 * 8 + 1024
    assert plan.smem_dkdv == 12 * 8192 + 2 * 256 * 4 + 6 * 8 + 1024
    # two blocks of each kernel fit one SM's shared memory
    assert 2 * max(plan.smem_fwd, plan.smem_dq, plan.smem_dkdv) <= MAX_SMEM


def test_every_tc_plan_fits_shared_memory():
    for n in range(1, K.TC_MAX_N + 1):
        plan = K.flash_plan((2, n, 128), 2, BF16)
        assert plan.route == "tc"
        assert max(plan.smem_fwd, plan.smem_dq, plan.smem_dkdv) <= MAX_SMEM


@pytest.mark.parametrize("shape,heads,dtype", [
    ((128, 197, 768), 12, torch.float32),     # fp32 keeps its 1e-5 bar
    ((4, 257, 768), 12, BF16),
    ((4, 512, 768), 12, BF16),
    ((16, 64, 768), 24, BF16),                # head dim 32
    ((16, 64, 768), 6, BF16)])                # head dim 128
def test_flash_plan_sends_the_rest_to_the_cuda_cores(shape, heads, dtype):
    b, n, d = shape
    plan = K.flash_plan(shape, heads, dtype)
    assert plan.route == "cuda_core" and plan.np == n
    # csrc/mha_fused.cu's grids: 32 rows a block in all three kernels
    assert plan.grid_fwd == plan.grid_dq == plan.grid_dkdv == (
        -(-n // 32), heads, b)


# head dims 48 and 88 (EVA ViT-g: K2's eval forward only), and 768 over 5
# heads, which does not divide; head dim 80 has the pair since OPT-2.7B's
# LoRA training (tests/test_torch_vlm_train.py)
@pytest.mark.parametrize("shape,heads", [((2, 64, 96), 2), ((2, 64, 176), 2),
                                         ((2, 64, 768), 5)])
def test_flash_plan_refuses_head_dims_without_a_kernel(shape, heads):
    with pytest.raises(ValueError):
        K.flash_plan(shape, heads, BF16)


def test_flash_plan_route_request():
    shape = (8, 197, 768)
    assert K.flash_plan(shape, 12, BF16, route="cuda_core").route == \
        "cuda_core"
    with pytest.raises(ValueError):
        K.flash_plan(shape, 12, torch.float32, route="tc")
    with pytest.raises(ValueError):
        K.flash_plan((8, 300, 768), 12, BF16, route="tc")
    with pytest.raises(ValueError):
        K.flash_plan(shape, 12, BF16, route="wgmma")
    with pytest.raises(TypeError):
        K.flash_plan(shape, 12, torch.float16)


def test_launch_helpers_refuse_cpu_tensors():
    q = torch.zeros((2, 64, 128), dtype=BF16)
    plan = K.flash_plan(q.shape, 2, BF16)
    with pytest.raises(ValueError):
        K.launch_fwd_lse(plan, q, q, q, heads=2)
    lse = torch.zeros((2, 2, 64))
    with pytest.raises(ValueError):
        K.launch_flash_bwd(plan, q, q, q, q, q, lse, heads=2)


def _inputs(b, n, d, seed, fully_masked=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, n, d)).astype(np.float32)
                   for _ in range(4))
    lens = rng.integers(1, n + 1, b)
    lens[0] = n
    if fully_masked:
        lens[-1] = 0
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


@pytest.mark.parametrize("b,n,d,heads,masked,causal,fully_masked", [
    (2, 197, 128, 2, False, False, False),
    (2, 197, 128, 2, True, False, False),
    (2, 65, 128, 2, True, True, False),
    (3, 65, 128, 2, True, False, True)])
def test_plain_pair_matches_jax_kernels_at_tc_lengths(b, n, d, heads, masked,
                                                      causal, fully_masked):
    q, k, v, do, m = _inputs(b, n, d, b * n + heads, fully_masked)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(BF16) for a in (q, k, v, do))
    scale = float(1.0 / np.sqrt(d // heads))
    jo, jl = jmha._mha_fwd_lse(jq, jk, jv, heads=heads, scale=scale, mask=jm,
                               causal=causal, interpret=True)
    to, tl = K.mha_fwd_lse(tq, tk, tv, heads=heads, mask=tm, causal=causal)
    assert to.dtype == BF16 and tuple(tl.shape) == (b, heads, n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if fully_masked:
        # every key of the masked sample scores -1e30: the weights are
        # uniform over the n real keys on both sides
        np.testing.assert_allclose(tl[-1].numpy(), -1e30, rtol=1e-6)
    jg = jmha._mha_flash_bwd(jq, jk, jv, jo, jdo, jl, heads=heads,
                             scale=scale, mask=jm, causal=causal,
                             interpret=True)
    tg = K.mha_flash_bwd(tq, tk, tv, to, tdo, tl, heads=heads, mask=tm,
                         causal=causal)
    for j, (got, want) in enumerate(zip((to,) + tuple(tg),
                                        (jo,) + tuple(jg))):
        assert got.dtype == BF16
        _bf16_close(got, want, rel_to_max=2e-3 if j else 0.0)
    assert K.mha_fwd_lse.launches == 0 and K.mha_flash_bwd.launches == 0
    assert K.mha_fwd_lse.route_launches == {"tc": 0, "tc32": 0,
                                            "cuda_core": 0}


def test_fully_masked_causal_row_follows_mha_reference():
    """A fully masked sample under causal masking: every score is -1e30
    (the key bias, then ``where(causal, s, -1e30)``), so the weights are
    uniform over all N keys, as in the JAX ``mha_reference`` graph (which
    the JAX custom VJP differentiates). The Pallas ``_fwd_lse_drop_kernel``
    adds the causal mask as a bias instead (-2e30 past the diagonal) and
    spreads such a row over the keys up to the diagonal; the other samples
    agree with the Pallas pair within the bf16 limits."""
    b, n, d, heads = 3, 197, 128, 2
    q, k, v, do, m = _inputs(b, n, d, 29, fully_masked=True)
    jm = jnp.asarray(m)
    tm = torch.from_numpy(m)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(BF16) for a in (q, k, v, do))
    scale = float(1.0 / np.sqrt(d // heads))
    to, tl = K.mha_fwd_lse(tq, tk, tv, heads=heads, mask=tm, causal=True)
    _bf16_close(to, jmha.mha_reference(jq, jk, jv, heads=heads, mask=jm,
                                       causal=True))
    np.testing.assert_allclose(tl[-1].numpy(), -1e30, rtol=1e-6)
    jo, jl = jmha._mha_fwd_lse(jq, jk, jv, heads=heads, scale=scale, mask=jm,
                               causal=True, interpret=True)
    _bf16_close(to[:-1], jo[:-1])
    np.testing.assert_allclose(tl[:-1].numpy(), np.asarray(jl[:-1]),
                               rtol=1e-5, atol=1e-5)
    jg = jmha._mha_flash_bwd(jq, jk, jv, jo, jdo, jl, heads=heads,
                             scale=scale, mask=jm, causal=True,
                             interpret=True)
    tg = K.mha_flash_bwd(tq, tk, tv, torch.from_numpy(np.asarray(
        jo.astype(jnp.float32))).to(BF16), tdo, torch.from_numpy(
            np.asarray(jl)), heads=heads, mask=tm, causal=True)
    for got, want in zip(tg, jg):
        _bf16_close(got[:-1], want[:-1], rel_to_max=2e-3)
