"""PyTorch port, the conv image backbones in train mode against the JAX
package: one optimizer step of the port's ``train/loop.make_train_step``
against the JAX ``make_train_step`` over ``apply(train=True)``, per
family, from the same numpy weights (the JAX ``init`` tree's structure,
seeded values, random BatchNorm affine and running statistics; loaded
into the port's model through ``load_jax_tree``), fp32 on the CPU.

  * a [2, 4] stack of images, its second microbatch half padded; SGD lr
    0.05 with weight decay 0.03, class weights, label smoothing 0.1,
    every parameter trainable, every random site at rate 0;
  * the loss, the per-microbatch losses, the grad and param norms, every
    gradient (the JAX one recovered from its SGD update) and every
    updated parameter within 5e-5; the new BatchNorm running statistics
    (carried from one microbatch to the next, momentum per family) within
    1e-5;
  * full widths (``tests/test_torch_conv_train_cut.py`` runs the cut
    towers): ResNet-18 at full depth, ShuffleNetV2 x2.0 (2 units a
    stage) and MobileNetV3-L (9 of its 15 rows, every kind of block) at
    64 x 64; ConvNeXt-B, EfficientNet B0 / B5 (B5 with BN momentum 0.01)
    and EfficientNetV2-S (Fused-MBConv) on cut depths at 32 x 32
    (``CONFIGS`` / ``DEPTHS`` / ``REPEATS`` / ``ROWS`` patched on both
    sides). Depth is cut for the time and, in ShuffleNet and MobileNet,
    for the conditioning: at full depth two XLA compilations of the same
    JAX step (optimization level 0 and the default) give early-layer
    gradients 1-2% apart, fp32 cancellation in the batch-statistics
    backward of a random tower; on the cut towers both sides agree within
    1e-5. ResNet-50's Bottleneck, where the same holds at one block a
    stage, is held in the train forward only (logits, running stats);
  * the random sites, by position and rate: each train forward's dropout
    and stochastic-depth calls recorded on both sides (the JAX keys read
    at run time through ``jax.debug.callback``), with the key each draws
    from named by its derivation: MobileNet's dropout from the step key
    itself, EfficientNet's classifier dropout from ``fold_in(999)`` and
    its blocks' stochastic depth from ``fold_in(si * 1000 + j)`` at
    ``sd_prob * idx / total``, ConvNeXt's from ``fold_in(idx)`` at
    ``0.5 * idx / (total - 1)``; ShuffleNet and ResNet have none.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.data.images import (
    normalize_on_device as jnormalize)
from garbage_classification_rca_tpu.models import registry as jreg
from garbage_classification_rca_tpu.models.image import convnext as jconvnext
from garbage_classification_rca_tpu.models.image import efficientnet as jeff
from garbage_classification_rca_tpu.models.image import (
    efficientnet_v2 as jeffv2)
from garbage_classification_rca_tpu.models.image import (
    mobilenet_v3 as jmb)
from garbage_classification_rca_tpu.models.image import resnet as jresnet
from garbage_classification_rca_tpu.models.image import (
    shufflenet_v2 as jshuffle)
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu.train import loop as jloop
from garbage_classification_rca_tpu.train.optim import make_optimizer
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    export_jax_tree)
from garbage_classification_rca_tpu_torch.data.images import (
    normalize_on_device)
from garbage_classification_rca_tpu_torch.models import registry as treg
from garbage_classification_rca_tpu_torch.models.image import (
    convnext as tconvnext)
from garbage_classification_rca_tpu_torch.models.image import (
    efficientnet as teff)
from garbage_classification_rca_tpu_torch.models.image import (
    efficientnet_v2 as teffv2)
from garbage_classification_rca_tpu_torch.models.image import (
    mobilenet_v3 as tmb)
from garbage_classification_rca_tpu_torch.models.image import resnet as tresnet
from garbage_classification_rca_tpu_torch.models.image import (
    shufflenet_v2 as tshuffle)
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.core import Key
from garbage_classification_rca_tpu_torch.train import loop as tloop
from garbage_classification_rca_tpu_torch.train.optim import (
    make_optimizer as make_torch_optimizer)
from tests.test_torch_conv_backbones import FAST_COMPILE, _fill, _norms

torch.set_num_threads(2)

CLASS_WEIGHTS = [0.8, 1.25, 1.0, 1.1]
LR, REG, SMOOTH = 0.05, 0.03, 0.1
TOL = dict(rtol=5e-5, atol=5e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)

# cut depths, full widths: a stage's first block (the stride and width
# change) and, where the table has one, a second (the residual)
V1_CUT = lambda st: tuple(r[:-1] + (min(r[-1], 2),) for r in st[:4])
V2_CUT = lambda st: tuple(r[:-1] + (min(r[-1], 2),) for r in st[:4])
CONVNEXT_DEPTHS = (2, 1, 2, 1)
RES50_LAYERS = (1, 1, 1, 1)
SHUFFLE_REPEATS = (2, 2, 2)
# MobileNetV3's rows with each kind of block: ReLU / hardswish, with and
# without squeeze-excite, 3x3 / 5x5, stride 1 / 2, with the residual
MB_ROWS = (0, 1, 2, 3, 4, 6, 10, 11, 12)


def _cut(mp, name):
    """Patch `name`'s depth on both sides (the random sites stay at the
    configs' rates)."""
    if name in ("b0", "b5"):
        for mod in (jeff, teff):
            cfg = mod.CONFIGS[name]
            mp.setitem(mod.CONFIGS, name, dataclasses.replace(
                cfg, stages=V1_CUT(cfg.stages)))
    elif name == "eff_v2_small":
        for mod in (jeffv2, teffv2):
            cfg = mod.CONFIGS[name]
            mp.setitem(mod.CONFIGS, name, dataclasses.replace(
                cfg, stages=V2_CUT(cfg.stages)))
    elif name == "convnext":
        for mod in (jconvnext, tconvnext):
            mp.setattr(mod, "DEPTHS", CONVNEXT_DEPTHS)
    elif name == "shuffle_net":
        for mod in (jshuffle, tshuffle):
            mp.setattr(mod, "REPEATS", SHUFFLE_REPEATS)
    elif name == "mb":
        for mod in (jmb, tmb):
            mp.setattr(mod, "ROWS", tuple(mod.ROWS[i] for i in MB_ROWS))
    elif name == "res50":
        for mod in (jresnet, tresnet):
            mp.setitem(mod.CONFIGS, name, dataclasses.replace(
                mod.CONFIGS[name], layers=RES50_LAYERS))


def _rates_zero(mp, name):
    """Every random site at rate 0, on both sides."""
    if name in ("b0", "b5"):
        mods = (jeff, teff)
    elif name == "eff_v2_small":
        mods = (jeffv2, teffv2)
    else:
        mods = ()
    for mod in mods:
        cfg = mod.CONFIGS[name]
        mp.setitem(mod.CONFIGS, name, dataclasses.replace(
            cfg, dropout=0.0, sd_prob=0.0))
    if name == "convnext":
        for mod in (jconvnext, tconvnext):
            mp.setattr(mod, "SD_PROB", 0.0)
    if name == "mb":
        mp.setattr(tmb, "DROPOUT", 0.0)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for j, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{j}."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _tree(name, seed):
    jdef = jreg.get_image_model(name)
    rng = np.random.default_rng(seed)
    # a new function object each call: jax caches eval_shape by function,
    # and a tree traced before a depth was patched (another test in the
    # same process) would come back at the old depth
    params, state = _fill(jax.eval_shape(lambda k: jdef.init(k),
                                         jax.random.PRNGKey(0)), rng)
    _norms(params, state, rng)
    return jdef, params, state, rng


# the input side: 64 for the full-width towers, 32 for the cut ones
SIZE = {"shuffle_net": 64, "res18": 64, "mb": 64}


def _stack(rng, size):
    return {"image": rng.integers(0, 256, (2, 4, size, size, 3),
                                  dtype=np.uint8),
            "label": rng.integers(0, 4, (2, 4)).astype(np.int32),
            "valid": np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.int32)}


NAMES = ("shuffle_net", "res18", "mb", "convnext", "b0", "b5",
         "eff_v2_small")


@pytest.mark.parametrize("name", NAMES[:3])
def test_train_step_matches_jax(name, monkeypatch):
    check_train_step(name, monkeypatch)


def check_train_step(name, monkeypatch):
    """The step comparison above for `name` (``test_torch_conv_train_cut``
    runs it on the cut towers)."""
    _cut(monkeypatch, name)
    _rates_zero(monkeypatch, name)
    jdef, params, state, rng = _tree(name, NAMES.index(name) + 11)
    stack = _stack(rng, SIZE.get(name, 32))
    apply = jdef.apply
    if name == "mb":
        apply = functools.partial(jmb.apply, dropout_rate=0.0)

    opt = make_optimizer("sgd", LR, REG, jloop.all_trainable_mask(params))
    step = jloop.make_train_step(
        apply, opt, class_weights=CLASS_WEIGHTS, label_smoothing=SMOOTH,
        compute_dtype=jnp.float32, log_norms=True,
        batch_to_inputs=lambda mb: jnormalize(mb["image"],
                                              dtype=jnp.float32))
    args = (params, state, opt.init(params), stack, jax.random.PRNGKey(0))
    new_p, new_s, _, loss, losses, norms = step.lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    want_p, want_s = _flatten(new_p), _flatten(new_s)
    before = _flatten(params)
    # optax sgd over add_decayed_weights: p' = p - lr * (g + reg * p)
    want_g = {k: (before[k] - want_p[k]) / LR - REG * before[k]
              for k in before}

    model = treg.get_image_model(name).load_tree(params, state, device="cpu")
    topt = make_torch_optimizer("sgd", model.named_parameters(), LR, REG)
    tstep = tloop.make_train_step(
        model, topt, batch_to_inputs=lambda mb, key: (
            normalize_on_device(mb["image"], dtype=torch.float32),),
        class_weights=torch.tensor(CLASS_WEIGHTS), label_smoothing=SMOOTH)
    tloss, tlosses, tnorms = tstep({k: torch.from_numpy(v)
                                    for k, v in stack.items()}, Key(0))
    got = export_jax_tree(model)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}

    np.testing.assert_allclose(tloss.item(), float(loss), **TOL)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(losses), **TOL)
    # the norms of the JAX step's own gradients and updated parameters,
    # summed in fp64 (its fp32 reductions, compiled at XLA's optimization
    # level 0, drift by 5e-4 over ShuffleNet's 7M parameters)
    norm = lambda leaves: float(np.sqrt(sum(
        np.sum(np.square(a, dtype=np.float64)) for a in leaves)))
    np.testing.assert_allclose(tnorms["grad_norm"].item(),
                               norm(want_g.values()), **TOL)
    np.testing.assert_allclose(tnorms["param_norm"].item(),
                               norm(want_p.values()), **TOL)
    assert set(got) == set(want_p) | set(want_s)
    assert set(grads) == set(want_g)
    for k, v in want_p.items():
        g = export_jax_tree_leaf(model, k, grads[k])
        np.testing.assert_allclose(g, want_g[k], err_msg=f"grad {k}", **TOL)
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    for k, v in want_s.items():
        assert not np.array_equal(v, _flatten(state)[k]), k   # it moved
        np.testing.assert_allclose(got[k], v, err_msg=k, **STATS_TOL)


def export_jax_tree_leaf(model, name, a):
    """A parameter-shaped array of `model` (its gradient) in the JAX
    layout of that parameter."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if leaf == "w" and isinstance(owner, tcore.Linear):
        return a.T
    if leaf == "w" and isinstance(owner, tcore.Conv2d):
        return a.transpose(2, 3, 1, 0)
    return a


def test_bottleneck_train_forward_matches_jax(monkeypatch):
    """ResNet-50's Bottleneck (one block a stage) in train mode: logits
    within 5e-5 of their largest value, the new running statistics within
    1e-5. Its gradients are not held here: at this size two XLA
    compilations of the same JAX step (optimization level 0 and the
    default) already give early-layer gradients 2% apart (fp32
    cancellation in the batch-statistics backward of a random tower),
    where the backbones above agree within 1e-5."""
    _cut(monkeypatch, "res50")
    jdef, params, state, rng = _tree("res50", 23)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, s, x: jdef.apply(p, s, x, train=True))
    logits, new_s = fwd.lower(params, state, x).compile(
        compiler_options=FAST_COMPILE)(params, state, x)
    model = treg.get_image_model("res50").load_tree(params, state,
                                                    device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True).numpy()
    want = np.asarray(logits)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-5 * float(np.abs(want).max()))
    stats = export_jax_tree(model)
    for k, v in _flatten(new_s).items():
        assert not np.array_equal(v, _flatten(state)[k]), k
        np.testing.assert_allclose(stats[k], v, err_msg=k, **STATS_TOL)


# ---------------------------------------------------------------------------
# the random sites, by position and rate
# ---------------------------------------------------------------------------


# the fold_in data a site's key may come from: ConvNeXt's block index,
# EfficientNet's si * 1000 + j and its classifier's 999
FOLDS = sorted(set(range(64)) | {si * 1000 + j for si in range(8)
                                 for j in range(8)} | {999})


def _derivation(match, candidates):
    """The name of the candidate derivation that `match` accepts."""
    hits = [label for label, k in candidates if match(k)]
    assert len(hits) == 1, hits
    return hits[0]


def _jax_sites(name, params, state, x, rng_key, monkeypatch):
    """Each dropout / stochastic-depth call of the JAX train forward, in
    order: (kind, derivation of its key, rate, shape). The forward is
    jitted: the kind, rate and shape are read while it is traced, each
    key at run time through an ordered ``jax.debug.callback``."""
    cands = [("key", rng_key)] + [(n, jax.random.fold_in(rng_key, n))
                                  for n in FOLDS]
    static, keys = [], []

    def rec(kind, real):
        def f(key, x, rate, train):
            static.append((kind, round(rate, 9), tuple(x.shape)))
            jax.debug.callback(lambda k: keys.append(np.asarray(k)), key,
                               ordered=True)
            return real(key, x, rate, train)
        return f

    monkeypatch.setattr(jcore, "dropout", rec("dropout", jcore.dropout))
    monkeypatch.setattr(jcore, "stochastic_depth",
                        rec("stochastic_depth", jcore.stochastic_depth))
    fwd = jax.jit(lambda p, s, x, k: jreg.get_image_model(name).apply(
        p, s, x, train=True, rng=k)[0])
    args = (params, state, x, rng_key)
    jax.block_until_ready(fwd.lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args))
    jax.effects_barrier()
    assert len(keys) == len(static)
    return [(kind, _derivation(lambda c: np.array_equal(np.asarray(c), k),
                               cands), rate, shape)
            for (kind, rate, shape), k in zip(static, keys)]


def _port_sites(model, x, key, monkeypatch):
    cands = [("key", key)] + [(n, key.fold_in(n)) for n in FOLDS]
    log = []

    def rec(kind, real):
        def f(x, rate, generator):
            seed = generator.initial_seed()
            log.append((kind, _derivation(lambda k: k.seed == seed, cands),
                        round(rate, 9), tuple(x.shape)))
            return real(x, rate, generator)
        return f

    monkeypatch.setattr(tcore, "dropout", rec("dropout", tcore.dropout))
    monkeypatch.setattr(tcore, "stochastic_depth",
                        rec("stochastic_depth", tcore.stochastic_depth))
    with torch.no_grad():
        model(torch.from_numpy(x), train=True, key=key)
    return log


def _nhwc(shape):
    """JAX activations are NHWC, the port's conv trunk NCHW."""
    return shape if len(shape) != 4 else (shape[0], shape[2], shape[3],
                                          shape[1])


@pytest.mark.parametrize("name", ["mb", "convnext", "b0", "eff_v2_small"])
def test_random_sites_match_jax_by_position_and_rate(name, monkeypatch):
    _cut(monkeypatch, name)
    jdef, params, state, rng = _tree(name, 3)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = _jax_sites(name, params, state, x, jax.random.PRNGKey(4),
                      monkeypatch)
    model = treg.get_image_model(name).load_tree(params, state, device="cpu")
    got = _port_sites(model, x, Key(4), monkeypatch)
    got = [(k, d, r, _nhwc(s) if k == "stochastic_depth" and name != "convnext"
            else s) for k, d, r, s in got]
    assert got == want
    if name == "mb":
        assert want == [("dropout", "key", 0.2, (2, 1280))]
    elif name == "convnext":
        total = sum(CONVNEXT_DEPTHS)
        assert [(d, r) for _, d, r, _ in want] == [
            (i, round(0.5 * i / (total - 1), 9)) for i in range(total)]
    else:
        cfg = (teff if name == "b0" else teffv2).CONFIGS[name]
        assert want[-1] == ("dropout", 999, cfg.dropout, (2, cfg.head_out))
        total = sum(r[-1] for r in cfg.stages)
        idx = {}
        for si, row in enumerate(cfg.stages):
            for j in range(row[-1]):
                idx[si * 1000 + j] = len(idx)
        sd = want[:-1]
        assert sd and all(k == "stochastic_depth" and r == round(
            cfg.sd_prob * idx[d] / total, 9) for k, d, r, _ in sd)


@pytest.mark.parametrize("name", ["res18", "shuffle_net"])
def test_resnet_and_shufflenet_draw_nothing(name, monkeypatch):
    """No dropout and no stochastic depth in these towers, as in the JAX
    ``apply`` (which deletes its rng)."""
    _cut(monkeypatch, name)
    model = treg.get_image_model(name).build(4)
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    assert _port_sites(model, x, Key(4), monkeypatch) == []


def test_batchnorm_sums_fp64_inputs_in_fp64():
    """The port's BatchNorm sums a bf16 or fp32 input in fp32 and an fp64
    one in fp64 (phase 16 of ``chip_smoke.py`` holds the conv towers'
    gradients card against CPU in fp64), in train and eval mode."""
    from garbage_classification_rca_tpu_torch.nn.core import BatchNorm

    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 3, 5, 5, generator=g, dtype=torch.float64) * 3 + 1
    bn = BatchNorm(3).double()
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.2, 0.2, generator=g)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    want = ((x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
            * bn.scale[:, None, None] + bn.bias[:, None, None])
    y = bn(x, 1e-5, train=True, momentum=0.1)
    assert y.dtype == torch.float64
    assert float((y - want).abs().max()) < 1e-12
    assert bn.mean.dtype == torch.float64
    assert float((bn.mean - 0.1 * mean).abs().max()) < 1e-15
    ye = bn(x, 1e-5)
    inv = bn.scale / torch.sqrt(bn.var + 1e-5)
    assert ye.dtype == torch.float64
    assert float((ye - ((x - bn.mean[:, None, None]) * inv[:, None, None]
                        + bn.bias[:, None, None])).abs().max()) < 1e-12
    bf, ref = BatchNorm(3), BatchNorm(3)
    yb = bf(x.bfloat16(), 1e-5, train=True)
    yf = ref(x.bfloat16().float(), 1e-5, train=True)
    assert yb.dtype == torch.bfloat16 and bf.mean.dtype == torch.float32
    assert torch.equal(yb, yf.bfloat16())
    assert torch.allclose(bf.mean, ref.mean, atol=1e-6)
