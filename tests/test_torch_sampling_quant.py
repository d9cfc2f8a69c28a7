"""PyTorch port, ``ops/sampling.py`` and ``ops/quant.py`` against the JAX
package's (numpy inputs from seeds, the CPU):

  * ``filter_logits``: the same survivors as JAX, exactly, for temperature /
    top-k / top-p alone and together, with ties at the k-th and at the
    top-p cut and ``top_k`` > V; the surviving values within 1e-6
    relative;
  * ``sample_tokens``: greedy is the argmax (any key); ``top_k=1`` equals
    greedy for every key; a key gives the same draws again; the empirical
    frequencies of 40,000 draws match softmax(``filter_logits``) under a
    chi-square test at p > 1e-3 (the draws are not JAX's: threefry is not
    reproduced);
  * ``quantize_rows`` / ``dequantize`` and ``quantize_linear``: int8
    values identical to JAX's, scales within 1e-6 relative, scale 1 and
    exact zeros on an all-zero row or channel, half-to-even rounding;
  * the int8 witness that ``chip_smoke.py`` holds the card's int8 readings
    to: the JAX package's readings at OPT-2.7B's full width and 3 layers
    equal the values written there, and the port's equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from garbage_classification_rca_tpu.ops import quant as jquant
from garbage_classification_rca_tpu.ops import sampling as jsmp
from garbage_classification_rca_tpu_torch.nn import core
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.ops import quant as tquant
from garbage_classification_rca_tpu_torch.ops import sampling as tsmp

torch.set_num_threads(2)

V = 64


def _logits(seed, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (5, V)).astype(np.float32)
    if ties:
        # a coarse grid: many exact ties, at the k-th and the top-p cuts too
        x = np.round(x * 2) / 2
        x[0, :8] = 3.0
    return x


CASES = [(None, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.9),
         (0.5, 12, 0.8), (1.3, 100, 0.5), (None, 3, 1.0), (2.0, 0, 0.3),
         (1.0, 8, 1.0), (1.0, 0, 0.999)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("temperature,top_k,top_p", CASES)
def test_filter_logits_survivors_match_jax(temperature, top_k, top_p, ties):
    x = _logits(1 + int(ties), ties)
    jc = jsmp.SamplerConfig(temperature, top_k, top_p)
    tc = tsmp.SamplerConfig(temperature, top_k, top_p)
    want = np.asarray(jsmp.filter_logits(jnp.asarray(x), jc))
    got = tsmp.filter_logits(torch.from_numpy(x), tc).numpy()
    keep = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), keep)
    assert keep.sum(axis=1).min() >= 1
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)
    if top_k and top_k < V and ties and top_p >= 1.0:
        # ties at the k-th logit are all kept
        assert (keep.sum(axis=1) >= min(top_k, V)).all()


def test_greedy_and_top_k1_are_the_argmax_for_any_key():
    x = torch.from_numpy(_logits(3))
    am = x.argmax(-1).to(torch.int32)
    assert torch.equal(tsmp.sample_tokens(None, x, tsmp.GREEDY), am)
    want = np.asarray(jsmp.sample_tokens(jax.random.PRNGKey(0),
                                         jnp.asarray(x.numpy()),
                                         jsmp.GREEDY))
    assert np.array_equal(am.numpy(), want)
    for seed in range(5):
        got = tsmp.sample_tokens(Key(seed), x, tsmp.SamplerConfig(
            temperature=0.3 + seed, top_k=1, top_p=0.7))
        assert torch.equal(got, am)


def test_draws_are_per_key_and_follow_the_filtered_softmax():
    cfg = tsmp.SamplerConfig(temperature=0.8, top_k=6, top_p=0.95)
    row = torch.from_numpy(_logits(4)[:1, :8].copy())
    n = 40000
    x = row.expand(n, 8)
    a = tsmp.sample_tokens(Key(11), x, cfg)
    assert torch.equal(a, tsmp.sample_tokens(Key(11), x, cfg))
    assert not torch.equal(a, tsmp.sample_tokens(Key(12), x, cfg))
    assert a.dtype == torch.int32
    p = torch.softmax(tsmp.filter_logits(row, cfg), dim=-1)[0].double()
    counts = np.bincount(a.numpy(), minlength=8)
    keep = p.numpy() > 0
    assert 2 <= keep.sum() < 8          # the filters removed some ids
    assert counts[~keep].sum() == 0
    exp = p.numpy()[keep]
    chi = stats.chisquare(counts[keep], n * exp / exp.sum())
    assert chi.pvalue > 1e-3, chi


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (2, 3, 7, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0                            # an all-zero row
    x[1, 0, 0, :3] = [127 * 0.5, -127 * 0.5, 127 * 1.5 / 2]
    qj, sj = jquant.quantize_rows(jnp.asarray(x))
    qt, st = tquant.quantize_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    assert st[0, 1, 2, 0] == 1.0 and (qt[0, 1, 2] == 0).all()
    for dtype, jd in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        got = tquant.dequantize(qt, st, dtype).float().numpy()
        want = np.asarray(jquant.dequantize(qj, sj, jd), np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # half to even, as jnp.round
    assert tquant.quantize_rows(torch.tensor([[0.5, 1.5, 2.5, 127.0]]))[
        0].tolist() == [[0, 2, 2, 127]]


def test_quantize_linear_matches_jax():
    rng = np.random.default_rng(6)
    lin = core.Linear(24, 10)
    w = rng.normal(0, 0.1, (24, 10)).astype(np.float32)    # JAX [in, out]
    w[:, 3] = 0.0                                          # a zero channel
    b = rng.normal(0, 0.1, (10,)).astype(np.float32)
    with torch.no_grad():
        lin.w.copy_(torch.from_numpy(w.T.copy()))
        lin.b.copy_(torch.from_numpy(b))
    qj = jquant.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tquant.quantize_linear(lin)
    assert lin.w.dtype == torch.int8 and not lin.w.requires_grad
    assert np.array_equal(lin.w.numpy().T, np.asarray(qj["w"]))
    np.testing.assert_allclose(lin.w_scale.numpy(), np.asarray(qj["w_scale"]),
                               rtol=1e-6)
    assert lin.w_scale[0, 3] == 1.0 and (lin.w[3] == 0).all()
    from garbage_classification_rca_tpu.nn import core as jnn

    x = rng.normal(size=(4, 24)).astype(np.float32)
    want = np.asarray(jnn.linear(qj, jnp.asarray(x)))
    got = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _jax_witness(params, ids, mask, dtype):
    """The JAX package's readings on ``chip_smoke``'s int8 witness in
    `dtype` (``chip_smoke.int8_witness_readings``' definitions): the tree
    cast, then quantized; the attention on the XLA graph, the JAX
    package's CPU default."""
    import chip_smoke
    from garbage_classification_rca_tpu.models.vlm import opt as jopt

    cfg = jopt.OPTConfig(layers=chip_smoke.SERVE_QUANT_LAYERS)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    b, t = mask.shape
    m = jnp.asarray(mask)
    emb = jopt.embed_tokens(p, jnp.asarray(ids))
    step = (jopt.embed_tokens(p, jnp.asarray(ids[:, 0])),
            jnp.full((b,), t, jnp.int32), m.sum(1) + cfg.pos_offset,
            jnp.pad(m, ((0, 0), (0, 1)), constant_values=1))

    def rel(a, ref):
        a, ref = (np.asarray(x, np.float32) for x in (a, ref))
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    h, c = jopt.prefill(p, emb, m, cfg, 1)
    lg = jopt.lm_head(p, h[:, -1])
    hd = jopt.decode_step(p, c, *step, cfg)[0]
    _, cq = jopt.prefill(p, emb, m, cfg, 1, cache_dtype="int8")
    cache = rel(jopt.decode_step(p, cq, *step, cfg)[0], hd)
    qp = jquant.quantize_opt_weights(p)
    hq, _ = jopt.prefill(qp, emb, m, cfg, 1)
    return {"weights": rel(jopt.lm_head(qp, hq[:, -1]), lg), "cache": cache}


def test_int8_witness_readings():
    """``chip_smoke``'s int8 witness (OPT-2.7B's widths at 3 layers, 16
    prompts). Weights: the JAX package's readings equal
    ``INT8_WITNESS_JAX``, within 1e-3 relative in fp32 and 1e-2 in bf16
    (XLA's CPU products may sum in another order on another CPU), and the
    port's fp32 reading equals JAX's within 1e-3 relative (the int8
    weights are the same bits on both sides). Cache: JAX's and the port's
    readings under ``INT8_CACHE_BAR``, the JAX test_quant.py bar (an
    activation within ~1e-6 of a rounding boundary rounds the other way
    on the other side, so the two readings differ by ~1%: they are not
    held to each other). Phase 17 holds the card to the same values."""
    import chip_smoke

    params, ids, mask = chip_smoke.int8_witness_inputs()
    with torch.no_grad():
        port = chip_smoke.int8_witness_readings(params, ids, mask, "cpu",
                                                torch.float32)
    assert port["cache"] < chip_smoke.INT8_CACHE_BAR, port
    for dtype, tol in ((jnp.float32, 1e-3), (jnp.bfloat16, 1e-2)):
        got = _jax_witness(params, ids, mask, dtype)
        want = chip_smoke.INT8_WITNESS_JAX[jnp.dtype(dtype).name]
        assert abs(got["weights"] - want) <= tol * want, (dtype, got)
        assert got["cache"] < chip_smoke.INT8_CACHE_BAR, (dtype, got)
        if dtype == jnp.float32:
            assert abs(port["weights"] - got["weights"]) <= 1e-3 * want, \
                (port, got)
