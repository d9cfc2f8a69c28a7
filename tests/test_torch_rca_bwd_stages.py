"""PyTorch port, K3's staged route on the CPU: the launch plan of
``rca_fused_bwd`` and the dataflow its four kernels follow.

  * ``rca_bwd_plan`` at B = 1, 13, 16, 64: the stage kernels, their grids
    and shared memory (within the H100's 232,448 bytes a block), the
    workspace regions (16-byte aligned, disjoint, inside the buffer, shapes
    from the unit geometry), and the weight-gradient pass's tiles, which
    cover each of the 80,480 weight values exactly once. The per-sample
    route has no staged region; an unknown route raises. Exact checks.
  * The stages emulated with the port's ``ops.attention`` units and one
    ``torch.autograd.grad`` per (unit, sample), in stage order, writing and
    reading the plan's workspace regions (filled with NaN first, so a
    region read before it is written, or written over, shows): the
    self-attentions' outputs, the four dx slots, the pair sums dtsa =
    ti's dx_q + it's dx_kv and disa = ti's dx_kv + it's dx_q, dt / di =
    dx_q + dx_kv, and the weight gradients summed sample by sample in batch
    order. Held against the JAX package's Pallas ``rca_fused_bwd`` in
    interpret mode within 5e-5 (1 + |x|) (its backward bar), reverse on and
    off, t fp32 with i fp32 and with i bf16; di in bf16 (both sides round
    the same fp32 chain to bf16, and a value within the bar of a rounding
    boundary may round the other way) within one bf16 ulp more.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.kernels import rca_fused as jrca
from garbage_classification_rca_tpu_torch.kernels import rca_fused as R
from garbage_classification_rca_tpu_torch.ops import attention as tatt

from tests.test_torch_train_kernels import (  # noqa: F401
    _rca_inputs, _torch_layout, weights)

torch.set_num_threads(2)

SMEM_LIMIT = 232448          # dynamic shared memory of one H100 block
GEOM = {"sa_txt": (48, 128, 96), "sa_img": (80, 128, 96),
        "rca_ti": (96, 64, 48), "rca_it": (96, 64, 48)}   # d_in, d_kq, d_v


def _tensor_offsets():
    """Offset of each of the 32 weight tensors in the flat gradient, per
    unit: {unit: {wq, bq, wk, bk, wv, bv, g, be: offset}}."""
    out, at = {}, 0
    for name, (d_in, dkq, dv) in GEOM.items():
        sizes = {"wq": dkq * d_in, "bq": dkq, "wk": dkq * d_in, "bk": dkq,
                 "wv": dv * d_in, "bv": dv, "g": dv, "be": dv}
        out[name] = {}
        for k, n in sizes.items():
            out[name][k] = at
            at += n
    assert at == R.N_WEIGHTS
    return out


@pytest.mark.parametrize("b", [1, 13, 16, 64])
def test_staged_plan_stages_and_workspace(b):
    plan = R.rca_bwd_plan(b)
    assert plan == R.rca_bwd_plan(b, "staged") and plan.route == "staged"
    names = [s[0] for s in plan.stages]
    assert names == ["rca_bwd_self_fwd", "rca_bwd_cross", "rca_bwd_self_bwd",
                     "rca_bwd_wgrad"]
    assert all(n.startswith("rca_bwd") for n in names)   # the profiler's kind
    for _, grid, smem in plan.stages[:3]:
        assert grid == (b, 2) and 0 < smem <= SMEM_LIMIT
    tiles = R.wgrad_tiles()
    grid4 = plan.stages[3][1]
    assert grid4 == (len(tiles) // 2 + math.ceil(R.WGRAD_VECTORS / 32), 1)
    assert grid4[0] >= 100 and plan.stages[3][2] == 0
    c = {n: 2 * dkq + dv for n, (_, dkq, dv) in GEOM.items()}
    want = {"sa_p": (2, b, 16, c["sa_txt"]), "sa_a": (2, b, 16, 16),
            "sa_yh": (2, b, 16, 96), "sa_inv": (2, b, 16),
            "sa_out": (2, b, 16, 96),
            **{f"d_{n}": (b, 16, c[n]) for n in GEOM},
            "dx": (4, b, 16, 96), "ln": (4, b, 2, 96)}
    assert {k: s for k, (_, s) in plan.workspace.items()} == want
    spans = sorted((o, o + math.prod(s)) for o, s in plan.workspace.values())
    assert spans[0][0] == 0 and spans[-1][1] <= plan.floats
    for (o0, e0), (o1, _) in zip(spans, spans[1:]):
        assert e0 <= o1                      # disjoint
    assert all(o % 4 == 0 for o, _ in spans)  # 16-byte aligned
    assert plan.floats == -(-spans[-1][1] // 4) * 4


@pytest.mark.parametrize("b", [1, 13, 16, 64])
def test_wgrad_tiles_cover_every_weight_once(b):
    """Each block of the weight-gradient pass computes two 16 x 16 tiles of a
    unit's stacked [q | k | v columns][d_in] weight matrix, then 32 of the
    1,632 bias and LayerNorm values: together every weight exactly once,
    at every batch (the grid does not depend on it)."""
    off = _tensor_offsets()
    names = list(GEOM)
    hit = np.zeros(R.N_WEIGHTS, np.int64)
    tiles = R.wgrad_tiles()
    assert len(tiles) % 2 == 0
    for u, c0, k0 in tiles:
        d_in, dkq, dv = GEOM[names[u]]
        o = off[names[u]]
        for c in range(c0, c0 + 16):
            part, row = ("wq", c) if c < dkq else (
                ("wk", c - dkq) if c < 2 * dkq else ("wv", c - 2 * dkq))
            assert row < (dv if part == "wv" else dkq) and k0 + 16 <= d_in
            hit[o[part] + row * d_in + k0:o[part] + row * d_in + k0 + 16] += 1
    n_vec = 0
    for name in names:
        d_in, dkq, dv = GEOM[name]
        o = off[name]
        for c in range(2 * dkq + dv):       # q | k | v biases
            part, j = ("bq", c) if c < dkq else (
                ("bk", c - dkq) if c < 2 * dkq else ("bv", c - 2 * dkq))
            hit[o[part] + j] += 1
        for j in range(2 * dv):             # LayerNorm scale, then shift
            hit[o["g"] + j] += 1
        n_vec += 2 * dkq + 3 * dv
    assert n_vec == R.WGRAD_VECTORS
    assert (hit == 1).all()
    assert R.rca_bwd_plan(b).stages[3][1][0] * 32 >= \
        len(tiles) // 2 * 32 + n_vec


def test_per_sample_plan_and_unknown_route():
    plan = R.rca_bwd_plan(13, "per_sample")
    assert plan.route == "per_sample"
    assert set(plan.workspace) == {"part"}          # no staged region
    assert plan.workspace["part"] == (0, (13, R.N_WEIGHTS))
    assert plan.floats == 13 * R.N_WEIGHTS
    assert [s[0] for s in plan.stages] == ["rca_bwd_kernel", "rca_bwd_reduce"]
    assert plan.stages[0][1] == (13, 1) and plan.stages[0][2] <= SMEM_LIMIT
    assert plan.stages[1][1][0] * 256 >= R.N_WEIGHTS
    with pytest.raises(ValueError, match="unknown route"):
        R.rca_bwd_plan(16, "cluster")
    with pytest.raises(ValueError, match="batch"):
        R.rca_bwd_plan(-1)


def test_wrapper_takes_the_route_argument(weights):
    """CPU tensors run the plain version on either route (no launch is
    counted) and an unknown route raises before anything runs."""
    _, block = weights
    t, i, g_ti, g_it = (torch.from_numpy(a) for a in _rca_inputs(2, seed=4))
    before = (R.rca_fused_bwd.launches, dict(R.rca_fused_bwd.route_launches))
    a = R.rca_fused_bwd(block, t, i, g_ti, g_it, reverse=True)
    c = R.rca_fused_bwd(block, t, i, g_ti, g_it, reverse=True,
                        route="per_sample")
    assert all(torch.equal(x, y) for x, y in zip(a[:2] + tuple(a[2]),
                                                 c[:2] + tuple(c[2])))
    assert (R.rca_fused_bwd.launches,
            R.rca_fused_bwd.route_launches) == before
    with pytest.raises(ValueError, match="unknown route"):
        R.rca_fused_bwd(block, t, i, g_ti, g_it, reverse=True, route="x")


def _unit_grad(unit8, xq, xkv, g, reverse):
    """One autograd.grad of one unit on one sample: (dx_q, dx_kv, its 8
    weight gradients)."""
    ws = [w.detach().requires_grad_() for w in unit8]
    xq = xq.detach().requires_grad_()
    xkv = xkv.detach().requires_grad_()
    u = R._units_of(ws * 4).sa_txt      # the 8 tensors as one unit
    with torch.enable_grad():
        out = tatt.reverse_cross_attention(u, xq, xkv, reverse)
        grads = torch.autograd.grad(out, [xq, xkv] + ws, g)
    return grads[0], grads[1], list(grads[2:])


def _emulate_staged(block, t, i, g_ti, g_it, reverse):
    """The staged route's dataflow at fp32 through the plan's workspace:
    (dt, di, [32 weight grads])."""
    b = t.shape[0]
    plan = R.rca_bwd_plan(b)
    work = torch.full((plan.floats,), float("nan"))
    view = {k: work[o:o + math.prod(s)].view(s)
            for k, (o, s) in plan.workspace.items()}
    ws = [w.detach().float() for w in R._weights(block)]
    unit8 = [ws[8 * u:8 * u + 8] for u in range(4)]
    units = R._units_of(ws)
    x = [t.float(), i.float()]
    # stage 1: sa_txt | sa_img forward, outputs stored
    for u, name in enumerate(("sa_txt", "sa_img")):
        for s in range(b):
            view["sa_out"][u, s] = tatt.self_attention(
                getattr(units, name), x[u][s:s + 1])[0]
    # stage 2: rca_ti (q t_sa, kv i_sa) | rca_it, dx_q / dx_kv to 4 slots
    per_sample = [[None] * b for _ in range(4)]
    for y, g in enumerate((g_ti, g_it)):
        for s in range(b):
            xq, xkv = view["sa_out"][y, s], view["sa_out"][1 - y, s]
            dq, dkv, gw = _unit_grad(unit8[2 + y], xq[None], xkv[None],
                                     g[s:s + 1].float(), reverse)
            view["dx"][2 * y, s], view["dx"][2 * y + 1, s] = dq[0], dkv[0]
            per_sample[2 + y][s] = gw
    # stage 3: the pair sums, then sa_txt | sa_img backward, dx_q + dx_kv
    dx = view["dx"]
    cot = (dx[0] + dx[3], dx[1] + dx[2])     # dtsa, disa
    dxs = []
    for u in range(2):
        rows = []
        for s in range(b):
            xs = x[u][s:s + 1]
            dq, dkv, gw = _unit_grad(unit8[u], xs, xs, cot[u][s:s + 1], False)
            rows.append(dq[0] + dkv[0])
            per_sample[u][s] = gw
        dxs.append(torch.stack(rows))
    # stage 4: each weight gradient summed sample by sample, in batch order
    grads = []
    for u in range(4):
        for k in range(8):
            acc = torch.zeros_like(per_sample[u][0][k])
            for s in range(b):
                acc = acc + per_sample[u][s][k]
            grads.append(acc)
    assert not (view["sa_out"].isnan().any() or view["dx"].isnan().any())
    return dxs[0].to(t.dtype), dxs[1].to(i.dtype), grads


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("i_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_staged_dataflow_matches_jax_kernel(weights, reverse, i_dtype):
    p, block = weights
    t, i, g_ti, g_it = _rca_inputs(5, seed=31 + reverse)
    it = torch.from_numpy(i)
    ji = jnp.asarray(i)
    if i_dtype == "bfloat16":
        it, ji = it.to(torch.bfloat16), ji.astype(jnp.bfloat16)
    dt, di, dw = _emulate_staged(block, torch.from_numpy(t), it,
                                 torch.from_numpy(g_ti),
                                 torch.from_numpy(g_it), reverse)
    jp, jdt, jdi = jrca.rca_fused_bwd(p, jnp.asarray(t), ji,
                                      jnp.asarray(g_ti), jnp.asarray(g_it),
                                      reverse=reverse, interpret=True)
    tol = dict(rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), **tol)
    want_di = np.asarray(jdi.astype(jnp.float32))
    got_di = di.float().numpy()
    assert di.dtype == it.dtype
    bar = 5e-5 * (1 + np.abs(want_di))
    if i_dtype == "bfloat16":
        bar = bar + _bf16_ulp(np.maximum(np.abs(got_di), np.abs(want_di)))
    assert (np.abs(got_di - want_di) <= bar).all()
    want_w = _torch_layout(jp)
    assert len(dw) == 32
    for g, w in zip(dw, want_w):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **tol)
