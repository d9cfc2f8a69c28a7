"""PyTorch port, the conv image backbones against the JAX package: the 12
ShuffleNetV2 / ResNet / MobileNetV3 / ConvNeXt / EfficientNet v1 and v2
classifiers at their full widths.

  * logits: the tree of the JAX ``init`` (its structure and shapes, from
    ``jax.eval_shape``; the values drawn from a numpy seed: torch's
    default fan-in ranges for weights, random BatchNorm affine and running
    statistics, LayerNorm scales around 1, ConvNeXt layer scales in
    +-0.2) goes into the JAX ``apply(train=False)`` (jitted, compiled
    without LLVM's expensive passes) and, through ``load_jax_tree``, into
    the port's model; fp32 on the CPU, 2 images of 64x64 (32x32 for
    res152, b5, eff_v2_large): |d| <= 1e-4 max|logit| and the same
    argmax;
  * BatchNorm folding: the folded port model's logits against the unfolded
    one's, |d| <= 1e-5 max|logit| (every BN gone; ConvNeXt has none);
  * converters: ``convert_torch`` of a torchvision-layout state dict
    (``tests/torch_refs``) gives the JAX converter's tree array for array,
    and the port's logits match the torch replica's (1e-4 max|logit|);
  * the primitives the towers add (relu, hardsigmoid, hardswish, max
    pool, fp32-accumulated global pool) and ShuffleNet's channel order;
  * the registry resolves every image name of the JAX registry, with the
    JAX package's BatchNorm eps; ``cli.test_image`` and ``load_tree`` of a
    conv backbone need CUDA unless the caller asks for the CPU.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.checkpoint.torch_convert import (
    numpy_state_dict)
from garbage_classification_rca_tpu.models import registry as jreg
from garbage_classification_rca_tpu.models.image import (
    shufflenet_v2 as jshuffle)
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu_torch.models import registry as treg
from garbage_classification_rca_tpu_torch.models.image import (
    efficientnet_common as teff)
from garbage_classification_rca_tpu_torch.models.image import (
    shufflenet_v2 as tshuffle)
from garbage_classification_rca_tpu_torch.nn import core as tcore
from garbage_classification_rca_tpu_torch.nn.fold import fold_batchnorm
from tests.torch_refs import efficientnet_ref as eref
from tests.torch_refs import misc_backbones_ref as mref

torch.set_num_threads(2)

NAMES = ("shuffle_net", "res18", "res50", "res152", "mb", "convnext", "b0",
         "b4", "b5", "eff_v2_small", "eff_v2_medium", "eff_v2_large")
SMALL_INPUT = {"res152": 32, "b5": 32, "eff_v2_large": 32}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _fill(tree, rng):
    """Numpy values for a tree of ShapeDtypeStructs: a conv (HWIO) or
    linear ([in, out]) weight U(+-1 / sqrt(fan_in)), a vector U(-0.2,
    0.2)."""
    def leaf(s):
        shape = tuple(s.shape)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 25
        u = rng.random(shape, dtype=np.float32) * 2.0 - 1.0
        return u * np.float32(1.0 / np.sqrt(fan_in))
    return jax.tree_util.tree_map(leaf, tree)


def _norms(p, s, rng):
    """Norm layers in place: every {scale, bias} pair's scale U(0.5, 1.5);
    a BatchNorm's running mean N(0, 0.2), variance U(0.5, 2)."""
    if isinstance(p, dict):
        if "scale" in p and "bias" in p:
            p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(
                np.float32)
        if "bn" in p:
            c = s["bn"]["mean"].shape
            s["bn"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
            s["bn"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        for k, v in p.items():
            _norms(v, s.get(k) if isinstance(s, dict) else None, rng)
    elif isinstance(p, list):
        for i, v in enumerate(p):
            _norms(v, s[i] if isinstance(s, list) else None, rng)


# XLA:CPU compiles these graphs 2-4x faster without LLVM's expensive passes
# (ResNet-152: 10 s -> 3 s on one core); the numerics are the same fp32 ops
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=1)
def _case(name):
    """(port model, x, JAX logits) of `name`: the JAX init's tree with
    seeded values in the JAX ``apply`` and, through ``load_jax_tree``, in
    the port's model; two seeded NHWC images."""
    jdef = jreg.get_image_model(name)
    rng = np.random.default_rng(NAMES.index(name))
    params, state = _fill(jax.eval_shape(jdef.init, jax.random.PRNGKey(0)),
                          rng)
    _norms(params, state, rng)
    size = SMALL_INPUT.get(name, 64)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    apply = jax.jit(lambda p, s, x: jdef.apply(p, s, x, train=False)[0])
    want = np.asarray(apply.lower(params, state, x).compile(
        compiler_options=FAST_COMPILE)(params, state, x))
    model = treg.get_image_model(name).load_tree(params, state, device="cpu")
    return model, x, want


def _close(got, want, rel):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# note: `check` varies fastest, so both checks of a name reuse its _case
@pytest.mark.parametrize("check", ["jax", "folded"])
@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax_and_fold(name, check):
    model, x, want = _case(name)
    got = model(torch.from_numpy(x)).numpy()
    if check == "jax":
        _close(got, want, 1e-4)
        assert (got.argmax(-1) == want.argmax(-1)).all()
        return
    mdef = treg.get_image_model(name)
    if name == "convnext":                   # no BatchNorm, nothing to fold
        assert "bn_eps" not in mdef.extras
        assert not any(isinstance(m, tcore.BatchNorm)
                       for m in model.modules())
        return
    model = fold_batchnorm(copy.deepcopy(model), mdef.extras["bn_eps"])
    assert all(m.bn is None for m in model.modules()
               if isinstance(m, teff.ConvBN))
    _close(model(torch.from_numpy(x)).numpy(), got, 1e-5)


def _randomize_bn(ref, seed):
    g = torch.Generator().manual_seed(seed)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.uniform_(-0.2, 0.2, generator=g)
            m.running_mean.normal_(0, 0.2, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)
    return ref.eval()


def _ref(name):
    """A torchvision-layout replica of `name` with random BN."""
    torch.manual_seed(11)
    if name == "shuffle_net":
        ref = mref.ShuffleNetV2Ref()
    elif name in ("res18", "res50"):
        block = mref.BasicBlock if name == "res18" else mref.Bottleneck
        ref = mref.ResNetRef(block, treg.get_image_model(name)
                             .extras["cfg"].layers)
    elif name == "mb":
        ref = mref.MobileNetV3Ref()
    elif name == "convnext":
        ref = mref.ConvNeXtRef()
        for m in ref.modules():              # let the blocks count
            if isinstance(m, mref.CNBlock):
                m.layer_scale.uniform_(-0.2, 0.2)
    elif name == "b0":
        cfg = treg.get_image_model(name).extras["cfg"]
        ref = eref.EfficientNetRef(list(cfg.stages), cfg.stem_out,
                                   cfg.head_out, eref.V1_NORM)
    else:
        ref = eref.EfficientNetRef(eref.V2_S_STAGES, 24, 1280, eref.V2_NORM)
    return _randomize_bn(ref, 12)


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}.{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


@pytest.mark.parametrize("name", ["shuffle_net", "res18", "res50", "mb",
                                  "convnext", "b0", "eff_v2_small"])
def test_convert_torch_gives_the_jax_tree_and_ref_logits(name):
    ref = _ref(name)
    sd = numpy_state_dict(ref)
    mdef = treg.get_image_model(name)
    got = mdef.convert_torch(sd, num_classes=4)
    want = jreg.get_image_model(name).convert_torch(sd, num_classes=4)
    _assert_same_tree(got, want)
    with pytest.raises(ValueError, match="classes"):
        mdef.convert_torch(sd, num_classes=5)
    model = mdef.load_tree(*got, device="cpu")
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    logits = model(x).numpy()
    _close(logits, ref(x.permute(0, 3, 1, 2).contiguous()).numpy(), 1e-4)


def test_primitives_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 9, 5)).astype(np.float32) * 4     # NHWC
    t = torch.from_numpy(x)
    for tf, jf in ((tcore.relu, jcore.relu),
                   (tcore.hardsigmoid, jcore.hardsigmoid),
                   (tcore.hardswish, jcore.hardswish)):
        np.testing.assert_allclose(tf(t).numpy(), np.asarray(jf(x)),
                                   atol=1e-6)
    nchw = lambda a: a.permute(0, 3, 1, 2)
    # all-negative input: a padded zero would win a max over the borders
    for a in (x, -np.abs(x) - 1.0):
        got = tcore.max_pool(nchw(torch.from_numpy(a)), 3, 2, padding=1)
        want = jcore.max_pool(jnp.asarray(a), 3, 2, padding=1)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))
    # bf16 input: the mean accumulates in fp32, then rounds once
    b = (x + 300.0).astype(jnp.bfloat16)
    got = tcore.global_avg_pool(nchw(torch.from_numpy(
        np.asarray(b, np.float32)).to(torch.bfloat16)))
    want = jcore.global_avg_pool(jnp.asarray(b))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_concat_shuffle_gives_the_jax_channel_order():
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(2, 2, 3, 4, 6)).astype(np.float32)   # NHWC
    cl = lambda v: torch.from_numpy(v).permute(0, 3, 1, 2)
    got = tshuffle.concat_shuffle(cl(a), cl(b))
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = jshuffle.channel_shuffle(jnp.concatenate([a, b], axis=-1))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    # the split unit's halves of a channels_last tensor are JAX's split
    h = cl(np.concatenate([a, b], axis=-1)).contiguous(
        memory_format=torch.channels_last)
    for got, want in zip(h.chunk(2, dim=1),
                         jnp.split(jnp.concatenate([a, b], -1), 2, -1)):
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))


def test_registry_resolves_every_jax_image_name():
    assert set(treg.IMAGE_MODELS) == set(jreg.IMAGE_MODELS)
    assert not hasattr(treg, "_UNPORTED_IMAGE")
    for name in jreg.IMAGE_MODELS:
        mdef, jdef = treg.get_image_model(name), jreg.get_image_model(name)
        assert mdef.extras.get("bn_eps") == jdef.extras.get("bn_eps"), name
        assert (mdef.depth is None) == (name in NAMES), name
    assert set(treg.TEXT_MODELS) == set(jreg.TEXT_MODELS)


def test_conv_cli_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    from garbage_classification_rca_tpu_torch.cli import test_image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GC_RCA_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_image.main(["--image_model=shuffle_net", "--model_path=x.pth"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treg.get_image_model("res18").load_tree({}, {})
