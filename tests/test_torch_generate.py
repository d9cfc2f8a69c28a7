"""PyTorch port, BLIP-2 / OPT generation against the JAX package on the
same weights and inputs (numpy, from seeds), fp32 on the CPU:

  * ``prefill``'s caches on the valid slots (the pad slots left out: both
    sides write them, and decode masks them), its hidden states, one
    ``decode_step`` and a ragged ``decode_chunk``, with the float and the
    int8 cache, against the JAX functions, within 1e-4 of the largest
    |value|; the int8 caches' values equal where the float K / V agree
    away from a rounding boundary;
  * ``generate``'s (tokens, valid), greedy, with the int8 cache and with
    int8 weights (a JAX ``quantize_opt_weights`` tree loaded into the
    port's int8 decoder), against JAX, and the first-step logits within
    1e-4 of max |logit|; the int8 ``Linear`` against the JAX ``linear``;
    ``speculative_generate`` against ``generate`` and the JAX function;
  * ``blip2.generate`` / ``prompt_embeds`` with the adapters on, against
    the JAX BLIP-2 at a narrow configuration (OPT head dim 80);
  * sampled ``generate``: deterministic per key, ``top_k=1`` equal to
    greedy, EOS semantics.

Token streams are held equal outright: the fp32 logits of the two sides
differ by ~1e-6 and no compared step has a top-2 margin that small
(``_min_margin`` asserts it, so a near tie would show as such, not as a
token mismatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.vlm import blip2 as jblip2
from garbage_classification_rca_tpu.models.vlm import opt as jopt
from garbage_classification_rca_tpu.ops import quant as jquant
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_jax_tree)
from garbage_classification_rca_tpu_torch.models.vlm import opt as topt
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.ops import quant as tquant
from garbage_classification_rca_tpu_torch.ops import sampling as tsmp

torch.set_num_threads(2)

RTOL = 1e-4
JCFG = jopt.OPTConfig(layers=2, hidden=64, heads=4, ffn=128, vocab=300,
                      max_pos=64)
TCFG = topt.OPTConfig(layers=2, hidden=64, heads=4, ffn=128, vocab=300,
                      max_pos=64)
L, NEW = 9, 6


@pytest.fixture(autouse=True)
def _no_grad(monkeypatch):
    monkeypatch.delenv("GC_RCA_FUSED_ATTN", raising=False)
    with torch.no_grad():
        yield


def _close(got, want, rtol=RTOL, rows=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if rows is not None:
        got, want = got[rows], want[rows]
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def opt_pair(seed=0, cfg=(JCFG, TCFG)):
    """(JAX params as numpy, the port's decoder) on the same weights."""
    jcfg, tcfg = cfg
    params = _np(jopt.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    params["final_ln"]["bias"] = rng.normal(
        0, 0.1, params["final_ln"]["bias"].shape).astype(np.float32)
    model = topt.OPTDecoder(tcfg).requires_grad_(False)
    load_jax_tree(model, params)
    return params, model


@pytest.fixture(scope="module")
def pair():
    return opt_pair()


def prompts(b=4, seed=1, l=L, hidden=64):
    """Embeddings and masks: a right-padded, a left-padded and a full
    row."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(b, l, hidden)).astype(np.float32)
    mask = np.ones((b, l), np.int32)
    mask[0, -3:] = 0
    mask[2, :2] = 0
    return emb, mask


def _t(*a):
    return [torch.from_numpy(np.asarray(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _min_margin(logits):
    s = np.sort(np.asarray(logits, np.float32), axis=-1)
    return float((s[..., -1] - s[..., -2]).min())


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_prefill_and_decode_step_match_jax(pair, cache_dtype):
    params, model = pair
    emb, mask = prompts()
    h_j, c_j = jopt.prefill(params, *_j(emb, mask), JCFG, NEW,
                            cache_dtype=cache_dtype)
    h_t, c_t = topt.prefill(model, *_t(emb, mask), NEW,
                            cache_dtype=cache_dtype)
    valid = mask.astype(bool)
    _close(h_t.numpy(), h_j, rows=valid)
    valid = np.pad(valid, ((0, 0), (0, NEW)))        # the cache's slots
    assert set(c_t) == set(c_j)
    for name in c_t:
        got, want = c_t[name].numpy(), np.asarray(c_j[name])
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == np.int8:
            # equal but where the fp32 value sits within 1e-4 of a
            # rounding boundary
            d = np.abs(got[:, valid].astype(int) - want[:, valid])
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
        else:
            _close(got, want, rows=(slice(None), valid))
        # the generation slots start empty
        tail = got[:, :, L:]
        assert (tail == (1 if name.endswith("scale") else 0)).all()
    # one step: token ids 1..4 at slot L, each row's next position
    b = mask.shape[0]
    tok = np.arange(1, b + 1, dtype=np.int32)
    wv = np.full((b,), L, np.int32)
    pos = mask.sum(1) + JCFG.pos_offset
    attn = np.pad(mask, ((0, 0), (0, NEW)))
    attn[:, L] = 1
    te = np.asarray(params["embed_tokens"]["w"])[tok]
    hd_j, cd_j = jopt.decode_step(params, c_j, *_j(te, wv, pos, attn), JCFG)
    hd_t, cd_t = topt.decode_step(model, c_t, *_t(te, wv, pos, attn))
    _close(hd_t.numpy(), hd_j)
    _close(topt.lm_head(model, hd_t).numpy(), jopt.lm_head(params, hd_j))
    if cache_dtype is None:
        _close(cd_t["k"][:, :, L].numpy(), np.asarray(cd_j["k"])[:, :, L])


def test_decode_chunk_matches_jax_and_sequential_steps(pair):
    """C = 3 tokens at ragged per-row offsets through one chunk, against
    the JAX ``decode_chunk``, and against the same tokens fed one by one
    through the port's ``decode_step``."""
    params, model = pair
    emb, mask = prompts(seed=2)
    b, c = mask.shape[0], 3
    _, c_j = jopt.prefill(params, *_j(emb, mask), JCFG, NEW)
    _, c_t = topt.prefill(model, *_t(emb, mask), NEW)
    c_seq = {k: v.clone() for k, v in c_t.items()}
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 300, (b, c)).astype(np.int32)
    base = np.array([L, L + 1, L, L + 2], np.int32)   # ragged offsets
    pos = (mask.sum(1) + JCFG.pos_offset)[:, None] + np.arange(c)[None]
    t_cache = L + NEW
    attn = np.zeros((b, c, t_cache), np.int32)
    for r in range(b):
        for j in range(c):
            attn[r, j, :L] = mask[r]
            attn[r, j, L:base[r] + j + 1] = 1
    te = np.asarray(params["embed_tokens"]["w"])[toks]
    h_j, cc_j = jopt.decode_chunk(params, c_j, *_j(te, base, pos, attn),
                                  JCFG)
    h_t, cc_t = topt.decode_chunk(model, c_t, *_t(te, base, pos, attn))
    _close(h_t.numpy(), h_j)
    for r in range(b):
        sl = slice(base[r], base[r] + c)
        _close(cc_t["k"][:, r, sl].numpy(), np.asarray(cc_j["k"])[:, r, sl])
    for j in range(c):
        hs, c_seq = topt.decode_step(model, c_seq, *_t(
            te[:, j], base + j, pos[:, j], attn[:, j]))
        _close(hs.numpy(), h_t[:, j].numpy(), rtol=1e-5)


@pytest.mark.parametrize("variant", ["greedy", "int8_cache",
                                     "int8_weights"])
def test_generate_matches_jax(pair, variant):
    """(tokens, valid) equal, EOS taken from inside a stream so that the
    valid mask ends early on a row."""
    params, model = pair
    emb, mask = prompts(seed=4)
    cache = "int8" if variant == "int8_cache" else None
    if variant == "int8_weights":
        params = jquant.quantize_opt_weights(params)
        params = _np(params)
        qmodel = topt.OPTDecoder(TCFG).requires_grad_(False)
        tquant.quantize_opt_weights(qmodel)
        load_jax_tree(qmodel, params)
        model = qmodel
        assert model.layers[0].q.w.dtype == torch.int8
    free_j, _ = jopt.generate(params, *_j(emb, mask), JCFG, NEW, eos_id=-1,
                              cache_dtype=cache)
    eos = int(np.asarray(free_j)[1, 2])
    want = jopt.generate(params, *_j(emb, mask), JCFG, NEW, eos_id=eos,
                         cache_dtype=cache)
    got = topt.generate(model, *_t(emb, mask), NEW, eos_id=eos,
                        cache_dtype=cache)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert not got[1].numpy().all()              # a row stopped at its EOS
    # the first step's logits
    h_j, _ = jopt.prefill(params, *_j(emb, mask), JCFG, NEW)
    h_t, _ = topt.prefill(model, *_t(emb, mask), NEW)
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    lg_j = jopt.lm_head(params, np.asarray(h_j)[np.arange(4), last])
    lg_t = topt.lm_head(model, topt.last_hidden(h_t, torch.from_numpy(mask)))
    _close(lg_t.numpy(), lg_j)
    assert _min_margin(lg_j) > 1e-3


def test_int8_weights_linear_and_cast(pair):
    """The int8 ``Linear``: x @ w, then the scale, then the bias, as the
    JAX ``nn.core.linear``; ``Blip2Model.cast_`` keeps int8 weights and
    their fp32 scales."""
    from garbage_classification_rca_tpu.nn import core as jnn

    params, _ = pair
    lp = params["layers"][0]["fc1"]
    q = _np(jquant.quantize_linear(lp))
    model = topt.OPTDecoder(TCFG).requires_grad_(False)
    tquant.quantize_opt_weights(model)
    lin = model.layers[0].fc1
    load_jax_tree(lin, q)
    x = np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32)
    _close(lin(torch.from_numpy(x)).numpy(), jnn.linear(q, jnp.asarray(x)),
           rtol=1e-6)
    assert lin.w_scale.shape == (1, 128)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    bm = blip2.Blip2Model.__new__(blip2.Blip2Model)
    torch.nn.Module.__init__(bm)
    bm.opt, bm.classifier, bm.lora = model, None, None
    blip2.Blip2Model.cast_(bm, torch.bfloat16)
    assert lin.w.dtype == torch.int8 and lin.w_scale.dtype == torch.float32
    assert lin.b.dtype == torch.bfloat16


@pytest.mark.parametrize("draft_k", [1, 3, 4])
def test_speculative_matches_generate(pair, draft_k):
    """The draft (another random OPT, 1 layer, narrower) proposes, the
    target checks; the output equals the target's greedy ``generate``,
    with an EOS inside a stream, and equals the JAX function's."""
    params, model = pair
    dj = jopt.OPTConfig(layers=1, hidden=32, heads=2, ffn=64, vocab=300,
                        max_pos=64)
    dt = topt.OPTConfig(layers=1, hidden=32, heads=2, ffn=64, vocab=300,
                        max_pos=64)
    dparams, draft = opt_pair(seed=7, cfg=(dj, dt))
    emb, mask = prompts(seed=5)
    ids = np.random.default_rng(6).integers(3, 300, mask.shape)
    demb = np.asarray(dparams["embed_tokens"]["w"])[ids]
    free, _ = topt.generate(model, *_t(emb, mask), NEW, eos_id=-1)
    eos = int(free[0, 3])
    want = topt.generate(model, *_t(emb, mask), NEW, eos_id=eos)
    got = topt.speculative_generate(model, draft, *_t(emb, demb, mask), NEW,
                                    draft_k=draft_k, eos_id=eos)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jgot = jopt.speculative_generate(params, dparams, *_j(emb, demb, mask),
                                     JCFG, dj, NEW, draft_k=draft_k,
                                     eos_id=eos)
    assert np.array_equal(got[0].numpy(), np.asarray(jgot[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(jgot[1]))


def test_sampled_generate_per_key_and_top_k1(pair):
    _, model = pair
    emb, mask = prompts(seed=8)
    e, m = _t(emb, mask)
    s = tsmp.SamplerConfig(temperature=1.5, top_k=40, top_p=0.95)
    a = topt.generate(model, e, m, NEW, eos_id=-1, sampler=s, rng=Key(3))
    b = topt.generate(model, e, m, NEW, eos_id=-1, sampler=s, rng=Key(3))
    c = topt.generate(model, e, m, NEW, eos_id=-1, sampler=s, rng=Key(4))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    greedy = topt.generate(model, e, m, NEW, eos_id=-1)
    k1 = topt.generate(model, e, m, NEW, eos_id=-1, rng=Key(9),
                       sampler=tsmp.SamplerConfig(temperature=0.7, top_k=1))
    assert torch.equal(k1[0], greedy[0])
    with pytest.raises(ValueError, match="requires rng"):
        topt.generate(model, e, m, NEW, sampler=s)
    with pytest.raises(ValueError, match="cache_dtype"):
        topt.prefill(model, e, m, NEW, cache_dtype="fp8")


def test_blip2_generate_matches_jax():
    """``blip2.generate`` with the adapters on (B drawn non-zero), the
    narrow configuration of ``tests/test_torch_vlm.py`` (EVA 176 / 2
    heads, OPT 160 / 2 heads: head dims 88 and 80), left-padded prompts;
    and ``prompt_embeds`` against JAX's."""
    from garbage_classification_rca_tpu.models.vlm import (
        blip2_vision as jvision)
    from garbage_classification_rca_tpu.models.vlm import qformer as jqf
    from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
        load_blip2_tree)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2
    from garbage_classification_rca_tpu_torch.models.vlm import (
        blip2_vision as tvision)
    from garbage_classification_rca_tpu_torch.models.vlm import qformer as tqf

    parts = dict(
        vision=dict(layers=2, hidden=176, heads=2, ffn=96),
        qformer=dict(layers=2, hidden=48, heads=4, ffn=64, n_query=8,
                     cross_frequency=2, vision_hidden=176),
        opt=dict(layers=2, hidden=160, heads=2, ffn=96, vocab=300,
                 max_pos=128))
    bj = jblip2.Blip2Config(
        vision=jvision.VisionConfig(**parts["vision"]),
        qformer=jqf.QFormerConfig(**parts["qformer"]),
        opt=jopt.OPTConfig(**parts["opt"]), lora_r=4, lora_alpha=8)
    bt = blip2.Blip2Config(
        vision=tvision.VisionConfig(**parts["vision"]),
        qformer=tqf.QFormerConfig(**parts["qformer"]),
        opt=topt.OPTConfig(**parts["opt"]), lora_r=4, lora_alpha=8)
    rng = np.random.default_rng(5)
    params = _np(jblip2.init(jax.random.PRNGKey(0), bj))
    lora = _np(jblip2.init_lora(jax.random.PRNGKey(1), bj))
    for layer in lora.values():
        for p in layer.values():
            p["b"] = rng.normal(0, 0.05, p["b"].shape).astype(np.float32)
    model = load_blip2_tree(blip2.build_model(bt, "cpu"), params, lora)
    pix = rng.normal(size=(3, 224, 224, 3)).astype(np.float32)
    mask = np.ones((3, 12), np.int32)
    mask[1, :5] = 0
    ids = rng.integers(4, 300, mask.shape).astype(np.int32) * mask + (
        1 - mask)
    BJ = bj
    e_j, m_j = jblip2.prompt_embeds(params, *_j(pix, ids, mask), BJ)
    e_t, m_t = blip2.prompt_embeds(model, *_t(pix, ids, mask))
    _close(e_t.numpy(), e_j)
    assert np.array_equal(m_t.numpy(), np.asarray(m_j))
    want = jblip2.generate(params, *_j(pix, ids, mask), BJ, lora=lora,
                           max_new_tokens=5, eos_id=-1)
    got = blip2.generate(model, *_t(pix, ids, mask), max_new_tokens=5,
                         eos_id=-1)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].numpy().all()
