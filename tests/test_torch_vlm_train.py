"""PyTorch port, BLIP-2's LoRA training and the Q-Former classifier's,
against the JAX package on the same weights and inputs (numpy, from seeds),
fp32 on the CPU:

  * the flash pair at head dim 80 (OPT-2.7B's LoRA training: causal with a
    left-pad key mask): the port's plain ``mha_fwd_lse_reference`` /
    ``mha_flash_bwd_reference`` (what its wrappers run on CPU tensors)
    against the JAX Pallas ``_mha_fwd_lse`` / ``_mha_flash_bwd`` in
    interpret mode, out and lse within 1e-5 + 1e-5|x|, dQ / dK / dV within
    5e-5 (1 + |x|); ``mha_flash_train`` under autograd against
    ``jax.vjp`` of the JAX ``mha_flash_train``; the plans take head dim 80
    on the CUDA cores and still refuse 88;
  * OPT's train branch and ``blip2.lm_loss`` with LoRA (B != 0) on a
    narrow configuration that keeps head dim 80 (OPT 2 layers of 160, 2
    heads, FFN 320; the tiny EVA / Q-Former of ``tiny_blip2_config``)
    against the JAX graph: the loss within 1e-5 relative, every adapter
    gradient within 5e-5 of its tensor's largest |g|, over labels with
    -100, a pad label token and a valid = 0 row;
  * one accumulated AdamW step of each trainer (``make_lora_train_step``,
    ``qformer_train.make_steps``) against the JAX one, at acc 2 over a
    window of 2 and a trailing window of 1 (divided by 2): the loss within
    1e-5, the AdamW moments within the gradient bar and the parameters
    within 1e-6 plus a share of the step (``MOMENT_REL`` says why); the
    AdamW rule alone against optax's within 1e-6 on the same gradients;
  * ``--hf_internal_dropout``: the sequence of dropout sites (shape, p)
    equal on both sides (the masks cannot be: the RNGs differ), the p = 0
    attention site consuming none; the port's loss from one key repeats
    bit for bit and differs from the loss without dropout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.cli import blip2_common as jbc
from garbage_classification_rca_tpu.cli import blip2_train as jtrain
from garbage_classification_rca_tpu.cli import qformer_train as jqtrain
from garbage_classification_rca_tpu.kernels import mha_fused as JK
from garbage_classification_rca_tpu.models.vlm import blip2 as jblip2
from garbage_classification_rca_tpu.models.vlm import opt as jopt
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_blip2_tree)
from garbage_classification_rca_tpu_torch.cli import blip2_common as tbc
from garbage_classification_rca_tpu_torch.cli import blip2_train as ttrain
from garbage_classification_rca_tpu_torch.cli import qformer_train as tqtrain
from garbage_classification_rca_tpu_torch.kernels import mha_fused as K
from garbage_classification_rca_tpu_torch.models.vlm import blip2
from garbage_classification_rca_tpu_torch.models.vlm import opt as topt
from garbage_classification_rca_tpu_torch.nn import core as tcore

torch.set_num_threads(2)

B, L, HEADS, DH = 3, 40, 2, 80


@pytest.fixture(autouse=True)
def _graph_attention(monkeypatch):
    """The JAX layers' own attention graph (their CPU default)."""
    for flag in ("GC_RCA_FUSED_ATTN", "GC_RCA_FLASH_BWD"):
        monkeypatch.delenv(flag, raising=False)


def _left_pad_mask(n, pads):
    return (np.arange(n)[None, :] >= np.asarray(pads)[:, None]).astype(
        np.int32)


def _fwd_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _bwd_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert bool((err <= 5e-5 * (1.0 + np.abs(want))).all()), float(err.max())


# ---------------------------------------------------------------------------
# K4a / K4b at head dim 80
# ---------------------------------------------------------------------------


def _pair_inputs(seed=80):
    """q / k / v / dO [3, 40, 160], the mask (sample 0 all pad, sample 1
    only its last key valid, sample 2 left-padded by 12) and the rows with
    an attendable key at or before the diagonal; dO is 0 on the other rows
    (pad positions that no valid query reads, whose flash weights follow
    no softmax: see the module docstring of ``tests/test_torch_vlm.py``)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, L, HEADS * DH)).astype(np.float32)
                   for _ in range(4))
    m = _left_pad_mask(L, [L, L - 1, 12])
    rows = np.cumsum(m, axis=1) > 0            # a valid key at or before
    do = do * rows[..., None]
    return q, k, v, do, m, rows


def test_flash_pair_plain_matches_pallas_at_head_dim_80():
    q, k, v, do, m, rows = _pair_inputs()
    assert rows.sum() < B * L and not rows[0].any() and rows[1].sum() == 1
    tq, tk, tv, tdo, tm = (torch.from_numpy(a) for a in (q, k, v, do, m))
    jq, jk, jv, jdo, jm = (jnp.asarray(a) for a in (q, k, v, do, m))
    scale = 1.0 / np.sqrt(DH)
    o, lse = K.mha_fwd_lse(tq, tk, tv, heads=HEADS, mask=tm, causal=True)
    jo, jlse = JK._mha_fwd_lse(jq, jk, jv, heads=HEADS, scale=scale,
                               mask=jm, causal=True, interpret=True)
    _fwd_close(o.numpy()[rows], np.asarray(jo)[rows])
    hrows = np.broadcast_to(rows[:, None], (B, HEADS, L))
    _fwd_close(lse.numpy()[hrows], np.asarray(jlse)[hrows])
    _fwd_close(o.numpy(), np.asarray(JK.mha_reference(
        jq, jk, jv, heads=HEADS, mask=jm, causal=True)))
    got = K.mha_flash_bwd(tq, tk, tv, o, tdo, lse, heads=HEADS, mask=tm,
                          causal=True)
    want = JK._mha_flash_bwd(jq, jk, jv, jnp.asarray(o.numpy()), jdo,
                             jnp.asarray(lse.numpy()), heads=HEADS,
                             scale=scale, mask=jm, causal=True,
                             interpret=True)
    for g, w in zip(got, want):
        _bwd_close(g.numpy(), w)
    assert K.mha_fwd_lse.launches == K.mha_flash_bwd.launches == 0


def test_mha_flash_train_at_head_dim_80_matches_jax_vjp():
    q, k, v, do, m, rows = _pair_inputs(81)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = K.mha_flash_train(tq, tk, tv, heads=HEADS,
                            mask=torch.from_numpy(m), causal=True)
    out.backward(torch.from_numpy(do))
    jout, vjp = jax.vjp(lambda a, b, c: JK.mha_flash_train(
        a, b, c, heads=HEADS, mask=jnp.asarray(m), causal=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    assert JK.flash_train_fits(q.shape, HEADS, 4)        # the Pallas pair
    _fwd_close(out.detach().numpy()[rows], np.asarray(jout)[rows])
    for g, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        _bwd_close(g.numpy(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plans_take_head_dim_80_on_the_cuda_cores(dtype):
    shape = (16, 136, 2560)                    # OPT-2.7B's LoRA microbatch
    assert K.flash_train_fits(shape, 32, dtype)
    assert not K.flash_drop_fits(shape, 32, dtype)
    plan = K.flash_plan(shape, 32, dtype)
    assert (plan.route, plan.bwd_route, plan.np) == ("cuda_core",
                                                     "cuda_core", 136)
    assert plan.grid_fwd == plan.grid_dq == plan.grid_dkdv == (5, 32, 16)
    # shared memory: the forward's Q / key tiles of stride 81 and 32 score
    # rows; the dK / dV kernel's 79,360 bytes (csrc/mha_fused.cu)
    assert plan.smem_fwd == 4 * (96 * 81 + 32 * 136)
    assert (plan.smem_dq, plan.smem_dkdv) == (70784, 79360)
    for route in ("tc", "tc32"):
        with pytest.raises(ValueError, match="route takes"):
            K.flash_plan(shape, 32, dtype, route=route)
    with pytest.raises(ValueError, match="head dims"):
        K.flash_plan(shape, 32, dtype, dropout=True)
    eva = (16, 257, 1408)                      # EVA ViT-g: head dim 88
    assert not K.flash_train_fits(eva, 16, dtype)
    with pytest.raises(ValueError, match="head dims"):
        K.flash_plan(eva, 16, dtype)


def test_mha_flash_train_raises_off_the_cpu_at_head_dim_88():
    """A shape no route takes raises on tensors that are not on the CPU
    (here the meta device, standing in for CUDA) rather than running the
    plain version; the CPU takes ``mha_reference`` there, as the JAX
    package takes its graph."""
    q = torch.zeros((2, 8, 176))
    assert K.mha_flash_train(q, q, q, heads=2).shape == q.shape
    q = q.to("meta")
    with pytest.raises(ValueError, match="head dims"):
        K.mha_flash_train(q, q, q, heads=2)


# ---------------------------------------------------------------------------
# the train branch and lm_loss on the JAX trees
# ---------------------------------------------------------------------------

TINY = jbc.tiny_blip2_config()
JCFG = jblip2.Blip2Config(
    vision=TINY.vision, qformer=TINY.qformer,
    opt=jopt.OPTConfig(layers=2, hidden=160, heads=2, ffn=320, vocab=300,
                       max_pos=256),
    lora_r=4, lora_alpha=8)
TCFG = blip2.Blip2Config(
    vision=tbc.tiny_blip2_config().vision,
    qformer=tbc.tiny_blip2_config().qformer,
    opt=topt.OPTConfig(layers=2, hidden=160, heads=2, ffn=320, vocab=300,
                       max_pos=256),
    lora_r=4, lora_alpha=8)
PROMPT = 20                                   # prompt tokens (left-padded)


def _np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@pytest.fixture(scope="module")
def trees():
    """(params, lora, classifier) of the JAX inits, fp32 numpy; B of the
    adapters drawn non-zero so that a and b both get gradient."""
    rng = np.random.default_rng(7)
    params = _np(jblip2.init(jax.random.PRNGKey(0), JCFG))
    lora = _np(jblip2.init_lora(jax.random.PRNGKey(1), JCFG))
    for layer in lora.values():
        for pair in layer.values():
            pair["b"] = rng.normal(0, 0.05, pair["b"].shape).astype(
                np.float32)
    clf = _np({"classifier": jblip2.init_classifier(jax.random.PRNGKey(2),
                                                    JCFG)})
    return params, lora, clf


def _port_model(trees, classifier=False):
    params, lora, clf = trees
    model = blip2.build_model(TCFG, "cpu", lora=not classifier,
                              classifier=classifier)
    return load_blip2_tree(model, params, None if classifier else lora,
                           clf if classifier else None)


def _microbatches(n, seed=3):
    """`n` host microbatches of B: uint8 images, left-padded prompts,
    4 label tokens with pads (id 1), labels, and valid = 0 on the last row
    of the last microbatch."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = _left_pad_mask(PROMPT, rng.integers(0, PROMPT - 2, B))
        lt = rng.integers(4, 300, (B, 4)).astype(np.int32)
        lt[0, 3] = lt[1, 2:] = 1                          # pad label tokens
        out.append({
            "image": rng.integers(0, 256, (B, 224, 224, 3), np.uint8),
            "input_ids": (rng.integers(4, 300, (B, PROMPT)) * mask
                          + (1 - mask)).astype(np.int32),
            "attention_mask": mask,
            "label_tokens": lt,
            "label": rng.integers(0, 4, B).astype(np.int32),
            "valid": np.asarray([1, 1, 0 if i == n - 1 else 1], np.int32)})
    return out


def _t(mb):
    return {k: torch.from_numpy(v) for k, v in mb.items()}


def _lora_grads(model):
    return {f"{i}.{n}.{ab}": getattr(getattr(model.lora[i], n), ab).grad
            for i in model.lora for n in ("q", "k") for ab in ("a", "b")}


def _jax_leaf(tree, path):
    i, n, ab = path.split(".")
    return np.asarray(tree[i][n][ab])


def test_assemble_lm_batch_matches_jax():
    mb = _microbatches(1)[0]
    got = ttrain._assemble_lm_batch(_t(mb), torch.float32)
    want = jtrain._assemble_lm_batch({k: jnp.asarray(v) for k, v in
                                      mb.items()}, jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    labels = got[3].numpy()
    assert (labels[2] == -100).all()               # valid = 0
    assert labels[0, -1] == -100 and labels[0, -2] != -100
    assert (labels[:, :PROMPT] == -100).all()


def test_shifted_ce_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 9, 17)).astype(np.float32)
    labels = rng.integers(0, 17, (3, 9)).astype(np.int32)
    labels[0, :5] = -100
    labels[2] = -100
    got = topt.shifted_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jopt.shifted_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full_like(labels, -100)
    assert float(topt.shifted_ce(torch.from_numpy(logits),
                                 torch.from_numpy(none))) == 0.0


def test_opt_train_refuses_attention_dropout():
    """A nonzero ``attention_dropout`` under an active HFDropout is refused
    (the flash pair at head dim 80 has no dropout variant); without one the
    site is never asked for and the layer runs."""
    cfg = dataclasses.replace(TCFG.opt, attention_dropout=0.1)
    model = topt.OPTDecoder(cfg)
    embeds = torch.zeros((1, 5, cfg.hidden))
    mask = torch.ones((1, 5), dtype=torch.int32)
    with torch.no_grad():
        topt.decode_hidden(model, embeds, mask, train=True)
        with pytest.raises(NotImplementedError, match="attention_dropout"):
            topt.decode_hidden(model, embeds, mask, train=True,
                               drop=tcore.HFDropout(tcore.Key(0)))


def test_lm_loss_and_adapter_grads_match_jax(trees):
    params, lora, _ = trees
    assert TCFG.opt.hidden // TCFG.opt.heads == DH
    mb = _microbatches(1)[0]
    model = _port_model(trees)
    model.lora.requires_grad_(True)
    x, ids, mask, labels = ttrain._assemble_lm_batch(_t(mb), torch.float32)
    loss = blip2.lm_loss(model, x, ids, mask, labels)
    loss.backward()
    jx, jids, jmask, jlabels = jtrain._assemble_lm_batch(
        {k: jnp.asarray(v) for k, v in mb.items()}, jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want, jgrads = jax.value_and_grad(lambda lo: jblip2.lm_loss(
        jparams, jx, jids, jmask, jlabels, JCFG, lo))(
        jax.tree_util.tree_map(jnp.asarray, lora))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for path, g in _lora_grads(model).items():
        w = _jax_leaf(jgrads, path)
        assert np.abs(w).max() > 0, path
        err = np.abs(g.numpy() - w).max()
        assert err <= 5e-5 * np.abs(w).max(), (path, err)
    # the frozen towers took no gradient and kept none
    assert all(p.grad is None for n, p in model.named_parameters()
               if not n.startswith("lora."))


def test_opt_train_branch_matches_eval_branch(trees):
    """The flash pair's forward (train) equals K2's (eval) on the plain
    versions: the same masks and the same hidden states."""
    model = _port_model(trees)
    rng = np.random.default_rng(9)
    n = 8 + PROMPT + 4
    embeds = torch.from_numpy(rng.normal(size=(3, n, 160)).astype(
        np.float32))
    mask = torch.from_numpy(_left_pad_mask(n, [0, 9, n - 1]))
    with torch.no_grad():
        a = topt.decode_hidden(model.opt, embeds, mask, lora=model.lora,
                               lora_scale=TCFG.lora_scale, train=True)
        b = topt.decode_hidden(model.opt, embeds, mask, lora=model.lora,
                               lora_scale=TCFG.lora_scale)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one accumulated optimizer step of each trainer
# ---------------------------------------------------------------------------


def _windows(mbs, acc):
    return [{k: np.stack([m[k] for m in mbs[i:i + acc]]) for k in mbs[0]}
            for i in range(0, len(mbs), acc)]


def _close_rel(got, want, rel, what="", extra=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + extra, (what, err)


# The whole step's bars. The gradients of the two packages differ by fp32
# summation order (measured here: up to 7e-6 of the tensor's largest |g|),
# so the AdamW moments are held to the gradient bar, 5e-5 of their largest
# |x|. An element whose gradient is near AdamW's eps (1e-5) turns such a
# difference into a visible part of its step (g / (|g| + eps)): the
# parameters are held to 1e-6 of their largest |x| plus 5e-3 of the
# learning rate (measured: up to 9.3e-4 of it). These bars cannot see the
# weight decay (lr 5e-4 x 0.01 x |p| ~ 5e-8 a step here): the update rule,
# the decay included, is held to 1e-6 on the same gradients, where a
# missing decay shows (``test_adamw_matches_optax``).
MOMENT_REL, PARAM_REL, STEP_SHARE = 5e-5, 1e-6, 5e-3


def test_lora_accum_step_matches_jax(trees):
    """acc 2 over three microbatches: a window of 2, then a trailing
    window of 1 whose gradient is still divided by 2; the loss of each
    window, then the adapters and the AdamW moments after each step."""
    params, lora, _ = trees
    windows = _windows(_microbatches(3, seed=5), 2)
    model = _port_model(trees)
    opt, step = ttrain.make_lora_train_step(model, acc_steps=2,
                                            compute_dtype=torch.float32)
    jopt_, jstep = jtrain.make_lora_train_step(
        JCFG, jax.tree_util.tree_map(jnp.asarray, params), acc_steps=2,
        compute_dtype=jnp.float32)
    jlora = jax.tree_util.tree_map(jnp.asarray, lora)
    jstate = jopt_.init(jlora)
    for win in windows:
        loss = step(_t(win))
        jlora, jstate, jloss = jstep(jlora, jstate, win, None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        adam = jstate[0]
        for path in _lora_grads(model):
            i, n, ab = path.split(".")
            p = getattr(getattr(model.lora[i], n), ab)
            _close_rel(p.detach().numpy(), _jax_leaf(jlora, path), PARAM_REL,
                       path, STEP_SHARE * ttrain.BLIP2_LR)
            st = opt.state[p]
            _close_rel(st["exp_avg"].numpy(), _jax_leaf(adam.mu, path),
                       MOMENT_REL, path + " mu")
            _close_rel(st["exp_avg_sq"].numpy(), _jax_leaf(adam.nu, path),
                       MOMENT_REL, path + " nu")


def test_adamw_matches_optax():
    """The trainers' AdamW (torch, lr 5e-4, eps 1e-5, weight decay 0.01)
    against the JAX trainers' optax chain on the same parameters and
    gradients, two steps: parameters and moments within 1e-6 of their
    largest |x|; the same AdamW without its weight decay misses that bar,
    so the decay is seen."""
    rng = np.random.default_rng(12)
    p0 = rng.normal(0, 0.1, (32, 16)).astype(np.float32)
    grads = [rng.normal(0, 1e-3, p0.shape).astype(np.float32)
             for _ in range(2)]
    grads[0][0, :4] = [1e-6, -3e-6, 1e-5, 0.0]          # near and at eps
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrain.blip2_adamw([p])
    jopt_ = jtrain._blip2_adamw()
    jp = jnp.asarray(p0)
    state = jopt_.init(jp)
    bare = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    no_decay = torch.optim.AdamW([bare], lr=ttrain.BLIP2_LR, eps=1e-5,
                                 weight_decay=0.0)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        bare.grad = torch.from_numpy(g)
        no_decay.step()
        upd, state = jopt_.update(jnp.asarray(g), state, jp)
        jp = jp + upd
        _close_rel(p.detach().numpy(), jp, 1e-6, "p")
        with pytest.raises(AssertionError):
            _close_rel(bare.detach().numpy(), jp, 1e-6, "p, no decay")
        _close_rel(opt.state[p]["exp_avg"].numpy(), state[0].mu, 1e-6, "mu")
        _close_rel(opt.state[p]["exp_avg_sq"].numpy(), state[0].nu, 1e-6,
                   "nu")


def test_qformer_accum_step_matches_jax(trees):
    params, _, clf = trees
    windows = _windows(_microbatches(3, seed=6), 2)
    model = _port_model(trees, classifier=True)
    opt, step, _ = tqtrain.make_steps(model, acc_steps=2,
                                      compute_dtype=torch.float32)
    jopt_, jstep, _ = jqtrain.make_steps(
        JCFG, jax.tree_util.tree_map(jnp.asarray, params), acc_steps=2,
        compute_dtype=jnp.float32)
    jt = jax.tree_util.tree_map(jnp.asarray, clf)
    jstate = jopt_.init(jt)
    for win in windows:
        loss = step(_t(win))
        jt, jstate, jloss = jstep(jt, jstate, win)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        adam = jstate[0]
        for leaf, p in (("w", model.classifier.w), ("b", model.classifier.b)):
            tr = (lambda a: a.T) if leaf == "w" else (lambda a: a)
            _close_rel(tr(p.detach().numpy()),
                       np.asarray(jt["classifier"][leaf]), PARAM_REL, leaf,
                       STEP_SHARE * ttrain.BLIP2_LR)
            _close_rel(tr(opt.state[p]["exp_avg"].numpy()),
                       np.asarray(adam.mu["classifier"][leaf]), MOMENT_REL,
                       leaf + " mu")
            _close_rel(tr(opt.state[p]["exp_avg_sq"].numpy()),
                       np.asarray(adam.nu["classifier"][leaf]), MOMENT_REL,
                       leaf + " nu")


# ---------------------------------------------------------------------------
# --hf_internal_dropout
# ---------------------------------------------------------------------------


def _record_sites(monkeypatch, cls, active):
    """Wrap `cls.__call__` to record (shape, p) of every site it
    consumes."""
    sites = []
    call = cls.__call__

    def wrapped(self, x, p):
        if active(self) and p > 0.0:
            sites.append((tuple(x.shape), float(p)))
        return call(self, x, p)

    monkeypatch.setattr(cls, "__call__", wrapped)
    return sites


def test_dropout_sites_match_jax(trees, monkeypatch):
    params, lora, _ = trees
    mb = _microbatches(1)[0]
    jsites = _record_sites(monkeypatch, jcore.HFDropout,
                           lambda d: d.rng is not None)
    tsites = _record_sites(monkeypatch, tcore.HFDropout,
                           lambda d: d.key is not None)
    keys_taken = []
    site_key = tcore.HFDropout.site_key
    monkeypatch.setattr(tcore.HFDropout, "site_key", lambda self, p: (
        keys_taken.append(p), site_key(self, p))[1])
    jx, jids, jmask, jlabels = jtrain._assemble_lm_batch(
        {k: jnp.asarray(v) for k, v in mb.items()}, jnp.float32)
    jblip2.lm_loss(jax.tree_util.tree_map(jnp.asarray, params), jx, jids,
                   jmask, jlabels, JCFG,
                   jax.tree_util.tree_map(jnp.asarray, lora),
                   rng=jax.random.PRNGKey(0), hf_internal_dropout=True)
    model = _port_model(trees)
    args = ttrain._assemble_lm_batch(_t(mb), torch.float32)
    with torch.no_grad():
        off = blip2.lm_loss(model, *args)
        on = [blip2.lm_loss(model, *args, drop=tcore.HFDropout(
            tcore.Key(11))) for _ in range(2)]
        other = blip2.lm_loss(model, *args,
                              drop=tcore.HFDropout(tcore.Key(12)))
    # the Q-Former's sites (its embeddings' output first), then OPT's:
    # peft's 0.05 on each adapter input, 0.1 on each layer's two outputs
    assert jsites[0] == ((B, JCFG.qformer.n_query, JCFG.qformer.hidden),
                         0.1)
    assert [p for _, p in jsites].count(0.05) == 2 * JCFG.opt.layers
    assert tsites == 3 * jsites                      # on, on, other
    # each OPT layer asks for its p = 0 attention site and consumes none
    assert keys_taken.count(0.0) == 3 * JCFG.opt.layers
    assert torch.equal(on[0], on[1])
    assert float(on[0]) != float(off) and float(other) != float(on[0])
