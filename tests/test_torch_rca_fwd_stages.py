"""PyTorch port, K1's staged route on the CPU: the launch plan of
``rca_fused`` and the dataflow its two kernels follow.

  * ``rca_fwd_plan`` at B = 1, 13, 16, 64, 128 on cards of 132 and 114
    SMs: the stage kernels, their grids and the samples a block (G1 = G2:
    1 while the 2B blocks are no more than the SMs, else 2, so that every
    grid fits one wave), every sample taken
    by exactly one block of each stage (the last block the ones left),
    shared memory within the H100's 232,448 bytes a block, the one
    workspace region (t_sa | i_sa: 16-byte aligned, inside the buffer).
    The per-sample route (the first version) has no workspace; an unknown
    route raises, on the CPU too. Exact checks.
  * The stages emulated with the port's ``ops.attention`` units, per
    (unit, sample group) block of the plan, through the plan's workspace
    region filled with NaN first (a slot read before it is written
    shows): stage 1 writes sa_txt / sa_img of its samples to sa_out, stage
    2 reads rca_ti's queries from t_sa and keys / values from i_sa (rca_it
    the other way round). Held against the JAX package's Pallas
    ``rca_fused`` in interpret mode within 2e-5 (1 + |x|), the JAX
    package's bar for this kernel; reverse on and off, t fp32 with i fp32
    and with i bf16, at one sample a block and at two (a ragged last
    block).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels.rca_fused import rca_fused as jax_rca
from garbage_classification_rca_tpu_torch.kernels import rca_fused as R
from garbage_classification_rca_tpu_torch.ops import attention as tatt

from tests.test_torch_train_kernels import weights  # noqa: F401

torch.set_num_threads(2)

SMEM_LIMIT = 232448          # dynamic shared memory of one H100 block
SM_SMEM = 233472             # an H100 SM's, 1 KB of it reserved a block


def _per_sm(smem):
    """Blocks of 256 threads and `smem` bytes that fit one SM."""
    return min(SM_SMEM // (smem + 1024), 2048 // 256)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b", [1, 13, 16, 64, 128])
def test_staged_fwd_plan_stages_and_workspace(b, sms):
    plan = R.rca_fwd_plan(b, sms=sms)
    assert plan == R.rca_fwd_plan(b, "staged", sms) and plan.route == "staged"
    assert [s[0] for s in plan.stages] == ["rca_fwd_self", "rca_fwd_cross"]
    assert len(plan.groups) == 2
    for (_, (gx, gy), smem), g in zip(plan.stages, plan.groups):
        assert gy == 2 and g in (1, 2) and 0 < smem <= SMEM_LIMIT
        # every sample in exactly one block of the stage, per unit
        hit = np.zeros(b, np.int64)
        for x in range(gx):
            hit[x * g:min(b, x * g + g)] += 1
        assert (hit == 1).all() and gx == math.ceil(b / g)
    # one sample a block while there are SMs for all 2B blocks, else two;
    # up to a batch of one sample an SM, each stage's grid fits one wave
    g = plan.groups[0]
    assert plan.groups == (g, g) and g == (1 if 2 * b <= sms else 2)
    for (_, (gx, gy), smem), one in zip(plan.stages, R.FWD_STAGE_SMEM):
        assert smem == one[g]
        if b <= sms:
            assert gx * gy <= sms * _per_sm(smem)
    if b == 128 and sms == 132:      # the eval batch
        assert plan.groups == (2, 2) and plan.stages[0][1] == (64, 2)
    if b == 16:                      # the train microbatch
        assert plan.groups == (1, 1)
    # two samples share one staged copy of a unit's weights: sa_img's
    # block then fills an SM, the cross blocks fit two an SM at one sample
    assert _per_sm(R.FWD_STAGE_SMEM[0][2]) == 1
    assert _per_sm(R.FWD_STAGE_SMEM[1][1]) == 2
    assert plan.workspace == {"sa_out": (0, (2, b, 16, 96))}
    assert plan.floats == 2 * b * 16 * 96 and plan.floats % 4 == 0


def test_per_sample_fwd_plan_and_unknown_route():
    plan = R.rca_fwd_plan(13, "per_sample")
    assert plan.route == "per_sample" and plan.groups == (1,)
    assert plan.workspace == {} and plan.floats == 0
    assert plan.stages == (("rca_fused_kernel", (13, 1),
                            R.PER_SAMPLE_FWD_SMEM),)
    assert R.PER_SAMPLE_FWD_SMEM == 165376 <= SMEM_LIMIT
    with pytest.raises(ValueError, match="unknown route"):
        R.rca_fwd_plan(16, "cluster")
    with pytest.raises(ValueError, match="batch"):
        R.rca_fwd_plan(-1)


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 16, 48)).astype(np.float32),
            rng.normal(size=(b, 16, 80)).astype(np.float32))


def test_wrapper_takes_the_route_argument(weights):
    """CPU tensors run the plain version on either route (no launch is
    counted) and an unknown route raises before anything runs."""
    _, block = weights
    t, i = (torch.from_numpy(a) for a in _inputs(2, seed=4))
    before = (R.rca_fused.launches, dict(R.rca_fused.route_launches))
    a = R.rca_fused(block, t, i, reverse=True)
    c = R.rca_fused(block, t, i, reverse=True, route="per_sample")
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert (R.rca_fused.launches, R.rca_fused.route_launches) == before
    assert set(R.rca_fused.route_launches) == set(R.FWD_ROUTES)
    with pytest.raises(ValueError, match="unknown route"):
        R.rca_fused(block, t, i, reverse=True, route="x")


def _emulate_staged(block, t, i, reverse, sms):
    """The staged route's dataflow at fp32 through the plan's workspace,
    block by block: (ti, it) in t's dtype."""
    b = t.shape[0]
    plan = R.rca_fwd_plan(b, sms=sms)
    work = torch.full((plan.floats,), float("nan"))
    off, shape = plan.workspace["sa_out"]
    sa_out = work[off:off + math.prod(shape)].view(shape)
    units = R._units_of([w.detach().float() for w in R._weights(block)])
    x = (t.float(), i.float())
    (_, (gx1, _), _), (_, (gx2, _), _) = plan.stages
    g1, g2 = plan.groups
    # stage 1: block (bx, y) writes sa_txt | sa_img of its samples
    for y, name in enumerate(("sa_txt", "sa_img")):
        for bx in range(gx1):
            lo, hi = bx * g1, min(b, bx * g1 + g1)
            sa_out[y, lo:hi] = tatt.self_attention(getattr(units, name),
                                                   x[y][lo:hi])
    # stage 2: rca_ti (queries t_sa, keys / values i_sa) | rca_it
    outs = [torch.full((b, 16, 48), float("nan")) for _ in range(2)]
    for y, name in enumerate(("rca_ti", "rca_it")):
        for bx in range(gx2):
            lo, hi = bx * g2, min(b, bx * g2 + g2)
            outs[y][lo:hi] = tatt.reverse_cross_attention(
                getattr(units, name), sa_out[y, lo:hi],
                sa_out[1 - y, lo:hi], reverse)
    assert not (sa_out.isnan().any() or outs[0].isnan().any()
                or outs[1].isnan().any())
    return outs[0].to(t.dtype), outs[1].to(t.dtype), plan.groups


@pytest.mark.parametrize("sms,groups", [(132, (1, 1)), (2, (2, 2))])
@pytest.mark.parametrize("i_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_staged_fwd_dataflow_matches_jax_kernel(weights, reverse, i_dtype,
                                                sms, groups):
    p, block = weights
    t, i = _inputs(5, seed=41 + reverse)
    it = torch.from_numpy(i)
    ji = jnp.asarray(i)
    if i_dtype == "bfloat16":
        it, ji = it.to(torch.bfloat16), ji.astype(jnp.bfloat16)
    ti_, it_, got_groups = _emulate_staged(block, torch.from_numpy(t), it,
                                           reverse, sms)
    assert got_groups == groups
    want = jax_rca(p, jnp.asarray(t), ji, reverse=reverse, interpret=True)
    for g, w in zip((ti_, it_), want):
        assert g.dtype == torch.float32 and g.shape == (5, 16, 48)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
