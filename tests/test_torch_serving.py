"""PyTorch port, ``serving/engine.GenerationServer`` (the CPU, fp32).

The contract of the JAX package's server: for any arrival order, queue
depth and slot count, each request's (tokens, valid) equal ``opt.generate``
on that request alone (padded on the right to ``max_prompt``), greedy,
sampled with ``Key(seed).fold_in(uid)`` and with the int8 cache; a slot's
new occupant never attends its predecessor's K / V; bad submissions raise
in ``submit``. On the CPU a server row is bit-identical to the B = 1
``generate`` (measured here: the streams are held equal outright). The
port's greedy streams are also held to the JAX server's on the same
weights and requests, and BLIP-2 prompts with the adapters on and int8
weights (a JAX ``quantize_opt_weights`` tree through ``load_blip2_tree``)
to the JAX ``blip2.generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.vlm import opt as jopt
from garbage_classification_rca_tpu.serving.engine import (
    GenerationServer as JServer)
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_jax_tree)
from garbage_classification_rca_tpu_torch.models.vlm import opt as topt
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.ops import sampling as smp
from garbage_classification_rca_tpu_torch.serving.engine import (
    GenerationServer)

torch.set_num_threads(2)

JCFG = jopt.OPTConfig(layers=2, hidden=32, heads=4, ffn=64, vocab=120,
                      max_pos=32)
TCFG = topt.OPTConfig(layers=2, hidden=32, heads=4, ffn=64, vocab=120,
                      max_pos=32)
MAX_PROMPT, MAX_NEW = 8, 6


@pytest.fixture(autouse=True)
def _no_grad(monkeypatch):
    monkeypatch.delenv("GC_RCA_FUSED_ATTN", raising=False)
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def pair():
    params = jax.tree_util.tree_map(
        np.asarray, jopt.init(jax.random.PRNGKey(0), JCFG))
    model = topt.OPTDecoder(TCFG).requires_grad_(False)
    load_jax_tree(model, params)
    return params, model


def _requests(n, seed=3):
    """n prompts of varying lengths, every third left-padded."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        l = int(rng.integers(2, MAX_PROMPT + 1))
        e = rng.normal(size=(l, TCFG.hidden)).astype(np.float32)
        m = np.ones((l,), np.int32)
        if i % 3 == 1 and l >= 4:
            e = np.concatenate([np.zeros((2, TCFG.hidden), np.float32), e])
            m = np.concatenate([np.zeros((2,), np.int32), m])
            e, m = e[:MAX_PROMPT], m[:MAX_PROMPT]
        out.append((e, m))
    return out


def _standalone(model, e, m, *, eos_id, max_new=MAX_NEW, **kw):
    """``generate`` on one request padded as the server pads it; the
    tokens up to and including its EOS (what the server records)."""
    pad = MAX_PROMPT - e.shape[0]
    e = torch.from_numpy(np.pad(e, ((0, pad), (0, 0))))[None]
    m = torch.from_numpy(np.pad(m.astype(np.int32), (0, pad)))[None]
    toks, valid = topt.generate(model, e, m, MAX_NEW, eos_id=eos_id, **kw)
    toks, valid = toks[0].numpy(), valid[0].numpy()
    return [int(t) for t in toks[valid]][:max_new]


def _pick_eos(model, reqs):
    """An id that appears inside a greedy stream, so that slots retire
    early and refill."""
    for e, m in reqs:
        return _standalone(model, e, m, eos_id=-1)[2]


def _check(served, want):
    assert len(served) == len(want)
    for uid, toks in want.items():
        req = served[uid]
        assert req.finished, uid
        assert req.tokens == toks, uid
        assert req.valid == [True] * len(toks)
        assert req.t_submit <= req.t_first <= req.t_done


@pytest.mark.parametrize("slots", [1, 3])
def test_greedy_matches_generate_per_request(pair, slots):
    _, model = pair
    reqs = _requests(7)
    eos = _pick_eos(model, reqs)
    srv = GenerationServer(model, slots=slots, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW, eos_id=eos)
    served = srv.run(reqs)
    _check(served, {u: _standalone(model, e, m, eos_id=eos)
                    for u, (e, m) in enumerate(reqs)})
    assert any(len(r.tokens) < MAX_NEW for r in served.values())


def test_greedy_streams_equal_the_jax_servers(pair):
    params, model = pair
    reqs = _requests(6, seed=9)
    eos = _pick_eos(model, reqs)
    kw = dict(slots=2, max_prompt=MAX_PROMPT, max_new=MAX_NEW, eos_id=eos,
              steps_per_sync=3)
    want = JServer(params, JCFG, **kw).run(reqs)
    got = GenerationServer(model, **kw).run(reqs)
    for uid in want:
        assert got[uid].tokens == want[uid].tokens, uid


def test_arrival_order_invariance(pair):
    _, model = pair
    reqs = _requests(6, seed=5)
    eos = _pick_eos(model, reqs)
    streams = []
    for order in ([0, 1, 2, 3, 4, 5], [5, 3, 1, 0, 4, 2]):
        srv = GenerationServer(model, slots=2, max_prompt=MAX_PROMPT,
                               max_new=MAX_NEW, eos_id=eos)
        uids = {srv.submit(*reqs[i]): i for i in order}
        srv.drain()
        streams.append({uids[u]: r.tokens for u, r in srv.requests.items()})
    assert streams[0] == streams[1]


def test_sampled_matches_generate_with_folded_key(pair):
    _, model = pair
    reqs = _requests(5, seed=7)
    s = smp.SamplerConfig(temperature=1.3, top_k=30, top_p=0.9)
    srv = GenerationServer(model, slots=2, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW, eos_id=-1, sampler=s,
                           rng=Key(21), steps_per_sync=2)
    served = srv.run(reqs)
    _check(served, {u: _standalone(model, e, m, eos_id=-1, sampler=s,
                                   rng=Key(21).fold_in(u))
                    for u, (e, m) in enumerate(reqs)})
    greedy = [_standalone(model, e, m, eos_id=-1) for e, m in reqs]
    assert [served[u].tokens for u in range(5)] != greedy
    with pytest.raises(ValueError, match="requires rng"):
        GenerationServer(model, slots=1, max_prompt=MAX_PROMPT,
                         max_new=MAX_NEW, sampler=s)


def test_int8_cache_matches_int8_generate(pair):
    _, model = pair
    reqs = _requests(5, seed=11)
    srv = GenerationServer(model, slots=3, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW, eos_id=-1, cache_dtype="int8")
    assert srv.caches["k"].dtype == torch.int8
    _check(srv.run(reqs), {u: _standalone(model, e, m, eos_id=-1,
                                          cache_dtype="int8")
                           for u, (e, m) in enumerate(reqs)})


@pytest.mark.parametrize("steps_per_sync", [1, 4, 7])
def test_steps_per_sync_is_throughput_only(pair, steps_per_sync):
    _, model = pair
    reqs = _requests(5, seed=13)
    eos = _pick_eos(model, reqs)
    srv = GenerationServer(model, slots=2, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW, eos_id=eos,
                           steps_per_sync=steps_per_sync)
    _check(srv.run(reqs), {u: _standalone(model, e, m, eos_id=eos)
                           for u, (e, m) in enumerate(reqs)})


def test_per_request_max_new(pair):
    _, model = pair
    reqs = _requests(4, seed=15)
    budgets = [1, 3, MAX_NEW, 2]
    srv = GenerationServer(model, slots=2, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW, eos_id=-1, steps_per_sync=2)
    for (e, m), n in zip(reqs, budgets):
        srv.submit(e, m, max_new=n)
    srv.drain()
    for u, ((e, m), n) in enumerate(zip(reqs, budgets)):
        assert srv.requests[u].tokens == _standalone(model, e, m,
                                                     eos_id=-1, max_new=n)
        assert len(srv.requests[u].tokens) == n
    for bad in (0, MAX_NEW + 1):
        with pytest.raises(ValueError, match="max_new"):
            srv.submit(*reqs[0], max_new=bad)


def test_tensor_submission_equals_numpy(pair):
    """Tensor embeddings (a tower's output on the device) and [1, L, H]
    shapes give the streams of numpy submissions."""
    _, model = pair
    reqs = _requests(3, seed=23)

    def serve(as_tensor):
        srv = GenerationServer(model, slots=2, max_prompt=MAX_PROMPT,
                               max_new=MAX_NEW, eos_id=-1)
        for e, m in reqs:
            if as_tensor:
                srv.submit(torch.from_numpy(e)[None], torch.from_numpy(m))
            else:
                srv.submit(e, m)
        srv.drain()
        return {u: r.tokens for u, r in srv.requests.items()}

    assert serve(True) == serve(False)


def test_bad_submissions_fail_at_the_api_boundary(pair):
    _, model = pair
    srv = GenerationServer(model, slots=1, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW)
    h = TCFG.hidden
    with pytest.raises(ValueError, match="max_prompt"):
        srv.submit(np.zeros((MAX_PROMPT + 1, h), np.float32),
                   np.ones((MAX_PROMPT + 1,), np.int32))
    with pytest.raises(ValueError, match="hidden"):
        srv.submit(np.zeros((4, h + 1), np.float32), np.ones((4,), np.int32))
    with pytest.raises(ValueError, match="attention_mask"):
        srv.submit(np.zeros((4, h), np.float32), np.ones((5,), np.int32))
    assert not srv.queue and not srv.requests       # nothing was queued
    with pytest.raises(ValueError, match="cache_dtype"):
        GenerationServer(model, slots=1, max_prompt=4, max_new=2,
                         cache_dtype="fp8")


def test_stale_kv_never_attended(pair):
    """One slot: a full-length request, then a short one; the second's
    stream is its standalone one."""
    _, model = pair
    rng = np.random.default_rng(17)
    long_ = (rng.normal(size=(MAX_PROMPT, TCFG.hidden)).astype(np.float32),
             np.ones((MAX_PROMPT,), np.int32))
    short = (rng.normal(size=(2, TCFG.hidden)).astype(np.float32),
             np.ones((2,), np.int32))
    srv = GenerationServer(model, slots=1, max_prompt=MAX_PROMPT,
                           max_new=MAX_NEW, eos_id=-1)
    served = srv.run([long_, short])
    assert served[1].tokens == _standalone(model, *short, eos_id=-1)


@pytest.mark.parametrize("int8_weights", [False, True])
def test_blip2_prompts_through_the_server_match_jax_generate(int8_weights):
    """The tiny BLIP-2 (``GC_RCA_TINY_BLIP2``'s geometry), the adapters' B
    drawn non-zero: ``prompt_embeds`` submitted to the server equal the JAX
    ``blip2.generate`` request for request; with `int8_weights` both sides
    run a JAX ``quantize_opt_weights`` tree (the port's through
    ``load_blip2_tree``)."""
    from garbage_classification_rca_tpu.cli.blip2_common import (
        tiny_blip2_config as jtiny)
    from garbage_classification_rca_tpu.models.vlm import blip2 as jblip2
    from garbage_classification_rca_tpu.ops.quant import quantize_opt_weights
    from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
        load_blip2_tree)
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        tiny_blip2_config)
    from garbage_classification_rca_tpu_torch.models.vlm import blip2

    jcfg, tcfg = jtiny(), tiny_blip2_config()
    params = jblip2.init(jax.random.PRNGKey(0), jcfg)
    lora = jax.tree_util.tree_map(
        lambda x: jax.random.normal(jax.random.PRNGKey(7), x.shape,
                                    x.dtype) * 0.1,
        jblip2.init_lora(jax.random.PRNGKey(1), jcfg))
    if int8_weights:
        params = dict(params, opt=quantize_opt_weights(params["opt"]))
    np_tree = jax.tree_util.tree_map(lambda a: np.asarray(a), (params, lora))
    model = load_blip2_tree(blip2.build_model(tcfg, "cpu"), *np_tree)
    assert (model.opt.layers[0].fc1.w.dtype == torch.int8) == int8_weights

    rng = np.random.default_rng(31)
    n, text_len, max_new = 4, 6, 5
    pix = rng.integers(0, 255, (n, 224, 224, 3)).astype(np.float32) / 255
    ids = rng.integers(4, 50000, (n, text_len)).astype(np.int32)
    masks = np.ones((n, text_len), np.int32)
    masks[1, -2:] = 0
    masks[3, :1] = 0
    e, m = blip2.prompt_embeds(model, *(torch.from_numpy(a)
                                        for a in (pix, ids, masks)))
    srv = GenerationServer(model.opt, slots=3,
                           max_prompt=tcfg.qformer.n_query + text_len,
                           max_new=max_new, eos_id=-1, lora=model.lora,
                           lora_scale=tcfg.lora_scale)
    for i in range(n):
        srv.submit(e[i], m[i])
    srv.drain()
    want, _ = jblip2.generate(params, *(jnp.asarray(a)
                                        for a in (pix, ids, masks)),
                              jcfg, lora=lora, max_new_tokens=max_new,
                              eos_id=-1)
    want = np.asarray(want)
    for i in range(n):
        assert srv.requests[i].tokens == want[i].tolist(), i
    got, valid = blip2.generate(model, *(torch.from_numpy(a)
                                         for a in (pix, ids, masks)),
                                max_new_tokens=max_new, eos_id=-1)
    assert np.array_equal(got.numpy(), want) and valid.all()
