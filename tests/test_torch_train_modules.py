"""PyTorch port, the training pieces around the kernels, against the JAX
package on the same numpy inputs (CPU):

  * BatchNorm in train mode: outputs and running stats vs JAX
    ``batchnorm(train=True)`` at 1e-5;
  * dropout / stochastic depth: inverted scaling and keep rates;
  * modality dropout: all four outcomes of the two coin flips (uniforms
    injected) and the gradient gate;
  * the CE loss vs JAX (class weights, smoothing, valid mask, a fully
    masked batch) at 1e-6;
  * SGD and AdamW over 3 steps with a freeze mask vs optax at 1e-6, the
    PlateauScheduler trace vs JAX;
  * the deterministic augmentation pieces vs JAX at 1e-5, the random
    draws on their ranges and firing rates;
  * the sampler, the batch plan with ``order`` and the stacked batches
    against the JAX copies.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from garbage_classification_rca_tpu.data import augment as jaug
from garbage_classification_rca_tpu.data import pipeline as jpipeline
from garbage_classification_rca_tpu.data import sampler as jsampler
from garbage_classification_rca_tpu.data.manifest import build_manifest as jbuild
from garbage_classification_rca_tpu.nn import core as jcore
from garbage_classification_rca_tpu.train import engine as jengine
from garbage_classification_rca_tpu.train import loss as jloss
from garbage_classification_rca_tpu.train import optim as joptim
from garbage_classification_rca_tpu_torch.data import augment as taug
from garbage_classification_rca_tpu_torch.data import pipeline as tpipeline
from garbage_classification_rca_tpu_torch.data import sampler as tsampler
from garbage_classification_rca_tpu_torch.data.manifest import build_manifest
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.nn import core
from garbage_classification_rca_tpu_torch.train import engine as tengine
from garbage_classification_rca_tpu_torch.train import loss as tloss
from garbage_classification_rca_tpu_torch.train import optim as toptim

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# nn pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 6, 5, 7)) * 3 + 1).astype(np.float32)   # NHWC
    scale = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 7).astype(np.float32)
    mean = rng.normal(size=7).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    want, st = jcore.batchnorm({"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)},
                               {"mean": jnp.asarray(mean),
                                "var": jnp.asarray(var)}, jx, train=True,
                               eps=1e-3, momentum=0.1)
    bn = core.BatchNorm(7)
    with torch.no_grad():
        for t, a in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean),
                     (bn.var, var)):
            t.copy_(torch.from_numpy(a))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)
    got = bn(tx.permute(0, 3, 1, 2), 1e-3, train=True, momentum=0.1)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().detach(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(st["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(st["var"]),
                               rtol=1e-5, atol=1e-5)


def test_batchnorm_train_gradient_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 4, 5)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 5).astype(np.float32)),
         "bias": jnp.zeros(5)}
    s = {"mean": jnp.zeros(5), "var": jnp.ones(5)}
    _, vjp = jax.vjp(lambda x_: jcore.batchnorm(p, s, x_, train=True,
                                                eps=1e-3)[0], jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    bn = core.BatchNorm(5)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(np.array(p["scale"])))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    bn(tx, 1e-3, train=True).backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dropout_and_stochastic_depth_scaling_and_keep_rates():
    x = torch.ones(200, 500)
    gen = core.Key(3).generator("cpu")
    y = core.dropout(x, 0.6, gen)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.4))
    assert abs(kept.float().mean().item() - 0.4) < 0.01
    assert core.dropout(x, 0.6, None) is x           # eval: identity
    assert core.dropout(x, 0.0, gen) is x
    z = core.stochastic_depth(torch.ones(4000, 3, 2, 2), 0.25,
                              core.Key(4).generator("cpu"))
    rows = z.flatten(1)
    assert bool(((rows == 0).all(1) | (rows == 1 / 0.75).all(1)).all())
    assert abs((rows[:, 0] != 0).float().mean().item() - 0.75) < 0.03
    # same key, same draws; another key, other draws
    a = core.dropout(x, 0.5, core.Key(9).generator("cpu"))
    b = core.dropout(x, 0.5, core.Key(9).generator("cpu"))
    c = core.dropout(x, 0.5, core.Key(9).fold_in(1).generator("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len({k.seed for k in core.Key(9).split(4)}) == 4


@pytest.mark.parametrize("u1,u2,img_kept,txt_kept", [
    (0.1, 0.5, False, True),     # drop, image
    (0.1, 0.9, True, False),     # drop, text
    (0.5, 0.5, True, True),      # no drop
    (0.9, 0.1, True, True)])     # no drop
def test_drop_modalities_outcomes_match_jax(monkeypatch, u1, u2, img_kept,
                                            txt_kept):
    from garbage_classification_rca_tpu.models.fusion import multimodal as jmm

    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    ids = rng.integers(1, 100, (2, 5)).astype(np.int32)
    mask = np.ones((2, 5), np.int32)
    # the JAX forward's two coin flips, fed the same two numbers
    draws = iter([u1, u2])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.float32(next(draws)))
    want = jmm.drop_modalities(jmm.FusionConfig(), jnp.asarray(images),
                               jnp.asarray(ids), jnp.asarray(mask),
                               train=True, rng=jax.random.PRNGKey(0))
    got = tmm.drop_modalities(tmm.FusionConfig(), torch.from_numpy(images),
                              torch.from_numpy(ids), torch.from_numpy(mask),
                              uniforms=torch.tensor([u1, u2]))
    assert bool(got[3]) == bool(want[3]) == img_kept
    assert bool(got[4]) == bool(want[4]) == txt_kept
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # eval: forced removal only, no keep flags
    out = tmm.drop_modalities(tmm.FusionConfig(), torch.from_numpy(images),
                              torch.from_numpy(ids), torch.from_numpy(mask),
                              remove_text=True)
    assert out[3] is None and not out[2].any()
    assert torch.equal(out[0], torch.from_numpy(images))


@pytest.mark.parametrize("keep", [True, False])
def test_grad_gate_cotangent(keep):
    x = torch.randn(3, 4, requires_grad=True)
    y = tmm._grad_gate(x * 2.0, torch.tensor(keep))
    assert torch.equal(y, x.detach() * 2.0)
    y.sum().backward()
    want = torch.full_like(x, 2.0) if keep else torch.zeros_like(x)
    assert torch.equal(x.grad, want)


# ---------------------------------------------------------------------------
# loss and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights,smoothing,valid", [
    (None, 0.0, None), ([0.5, 2.0, 1.0, 1.5], 0.0, None),
    ([0.5, 2.0, 1.0, 1.5], 0.1, [1, 1, 0, 1, 0, 1]),
    (None, 0.2, [0, 0, 0, 0, 0, 0])])
def test_cross_entropy_matches_jax(weights, smoothing, valid):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, 6).astype(np.int32)
    jw = None if weights is None else jnp.asarray(weights, jnp.float32)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    want, w_want = jloss.cross_entropy_loss_and_weight(
        jnp.asarray(logits), jnp.asarray(labels), jw, smoothing, jv)
    tl = torch.from_numpy(logits).requires_grad_()
    got, w_got = tloss.cross_entropy_loss_and_weight(
        tl, torch.from_numpy(labels),
        None if weights is None else torch.tensor(weights),
        smoothing, None if valid is None else torch.tensor(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w_got.item(), float(w_want), rtol=1e-6)
    got.backward()
    (jg,) = jax.grad(lambda l: jloss.cross_entropy_loss_and_weight(
        l, jnp.asarray(labels), jw, smoothing, jv)[0],
        argnums=(0,))(jnp.asarray(logits))
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    if valid is not None and not any(valid):      # fully masked: (0, 0)
        assert got.item() == 0.0 and w_got.item() == 0.0
        assert not tl.grad.any()


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("masked", [False, True])
def test_optimizers_match_optax(opt, masked):
    rng = np.random.default_rng(3)
    shapes = {"head": (4, 3), "tower": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    mask = {"head": True, "tower": not masked}
    jopt = joptim.make_optimizer(opt, 0.01, 0.03, mask if masked else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = toptim.make_optimizer(opt, tp.items(), 0.01, 0.03,
                                 mask if masked else None)
    for step, g in enumerate(grads):
        if step == 2:        # the plateau scheduler's lr rewrite
            state = joptim.set_learning_rate(state, 0.004)
            toptim.set_learning_rate(topt, 0.004)
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    if masked:       # frozen: no update, no decay
        np.testing.assert_array_equal(tp["tower"].detach().numpy(),
                                      params["tower"])
    assert toptim.get_learning_rate(topt) == pytest.approx(
        joptim.get_learning_rate(state), rel=1e-6)


def test_plateau_scheduler_trace_matches_jax():
    accs = [10.0, 20.0, 20.0, 19.0] + [20.0] * 12 + [35.0] + [30.0] * 12
    j = joptim.PlateauScheduler(0.01, factor=0.4, patience=3)
    t = toptim.PlateauScheduler(0.01, factor=0.4, patience=3)
    assert [t.step(a) for a in accs] == [j.step(a) for a in accs]
    assert (t.lr, t.best, t.num_bad) == (j.lr, j.best, j.num_bad)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

AUG_TOL = dict(rtol=1e-5, atol=1e-5)


def test_augment_matrices_match_jax():
    thetas = np.array([-1.4, -0.7, 0.0, 0.3, 1.2], np.float32)
    for h, w in ((48, 64), (64, 48), (40, 40)):
        for th in thetas:
            jh, jw = jaug.inscribed_rect(jnp.asarray(th), h, w)
            th_t = torch.tensor([th])
            th_h, th_w = taug.inscribed_rect(th_t, h, w)
            np.testing.assert_allclose([th_h.item(), th_w.item()],
                                       [float(jh), float(jw)], **AUG_TOL)
            np.testing.assert_allclose(
                taug.rotate_crop_matrix(th_t, h, w)[0].numpy(),
                np.asarray(jaug.rotate_crop_matrix(jnp.asarray(th), h, w)),
                **AUG_TOL)
    rng = np.random.default_rng(4)
    src = (rng.uniform(0, 50, (3, 4, 2))
           + np.array([[0, 0], [60, 0], [60, 60], [0, 60]])).astype(
               np.float32)
    dst = np.array([[0, 0], [63, 0], [63, 47], [0, 47]], np.float32)
    got = taug.solve_homography(torch.from_numpy(src),
                                torch.from_numpy(np.stack([dst] * 3)))
    for j in range(3):
        want = np.asarray(jaug.solve_homography(jnp.asarray(src[j]),
                                                jnp.asarray(dst)))
        np.testing.assert_allclose(got[j].numpy(), want, rtol=1e-4,
                                   atol=1e-4)


def test_perspective_matrix_matches_jax_given_its_corners():
    h, w = 48, 64
    for s in range(3):
        key = jax.random.PRNGKey(s)
        pts, mw, mh = map(np.asarray, jaug.perspective_params(key, h, w))
        want = np.asarray(jaug.perspective_matrix(key, h, w))
        got = taug.perspective_matrix(torch.from_numpy(pts)[None],
                                      torch.tensor([float(mw)]),
                                      torch.tensor([float(mh)]), h, w)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the corner sampling from its draws: jitter |N * scale| mod 0.32
    normals = torch.tensor([[[0.5, -1.0], [2.0, 0.1], [-0.3, 0.3],
                             [1.0, 1.0]]])
    pts, mw, mh = taug.perspective_corners(torch.tensor([0.1]), normals,
                                           h, w)
    jit = np.mod(np.abs(normals.numpy()[0] * 0.1), 0.32)
    np.testing.assert_allclose(pts[0, 0].numpy(),
                               jit[0] * np.array([w, h]), **AUG_TOL)
    assert mw.item() == math.floor(mw.item()) and 0 < mw.item() <= w


def test_warp_and_kernels_match_jax():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (2, 24, 32, 3)).astype(np.float32)
    mats = []
    for th in (0.4, -1.1):
        m = np.asarray(jaug.rotate_crop_matrix(jnp.asarray(th), 24, 32))
        c = np.array([[1, 0, 11.5], [0, 1, 15.5], [0, 0, 1]], np.float32)
        u = np.array([[1, 0, -11.5], [0, 1, -15.5], [0, 0, 1]], np.float32)
        mats.append((c @ m @ np.diag([0.8, 1.2, 1.0]) @ u).astype(np.float32))
    got = taug.warp_bilinear(torch.from_numpy(img),
                             torch.from_numpy(np.stack(mats)))
    for j in range(2):
        want = np.asarray(jaug._warp_bilinear(jnp.asarray(img[j]),
                                              jnp.asarray(mats[j]), 24, 32))
        np.testing.assert_allclose(got[j].numpy(), want, rtol=1e-4,
                                   atol=1e-3)
    sig = np.array([0.8, 1.3], np.float32)
    k = taug.gauss_kernel7(torch.from_numpy(sig))
    for j in range(2):
        np.testing.assert_allclose(
            k[j].numpy(), np.asarray(jaug._gauss_kernel7(jnp.asarray(sig[j]))),
            **AUG_TOL)
    got = taug.dwconv(torch.from_numpy(img), k)
    for j in range(2):
        want = np.asarray(jaug._dwconv(jnp.asarray(img[j]),
                                       jnp.asarray(k[j].numpy())))
        np.testing.assert_allclose(got[j].numpy(), want, rtol=1e-5,
                                   atol=1e-3)


def test_augment_batch_draw_ranges_and_firing_rates():
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.integers(0, 256, (64, 16, 16, 3),
                                           dtype=np.uint8))
    out = taug.augment_batch(images, 0.0, core.Key(1).generator("cpu"))
    assert out.dtype == torch.uint8 and out.shape == images.shape
    # prob 0: the identity warp, no photometric op (up to the float trip)
    assert (out.int() - images.int()).abs().max().item() <= 1
    out = taug.augment_batch(images, 1.0, core.Key(2).generator("cpu"))
    assert out.dtype == torch.uint8
    assert (out != images).flatten(1).any(1).all()
    # the homography's draws: flips fire at p, rotation within +-90 deg
    u = torch.rand((4000, 17), generator=core.Key(3).generator("cpu"))
    mats = taug.homography(u, torch.zeros(4000, 4, 2), 16, 16, 0.5)
    vflip = mats[:, 0, 0] * (u[:, 1] >= 0.5) * (u[:, 3] >= 0.5) \
        * (u[:, 5] >= 0.5) < 0
    assert abs(vflip.float().sum().item()
               / ((u[:, 1] >= 0.5) & (u[:, 3] >= 0.5)
                  & (u[:, 5] >= 0.5)).sum().item() - 0.5) < 0.06
    assert torch.isfinite(mats).all()
    assert float(((u[:, 0] * 2 - 1) * math.pi / 2).abs().max()) <= math.pi / 2


# ---------------------------------------------------------------------------
# data plumbing
# ---------------------------------------------------------------------------


def test_sampler_batch_plan_and_stacks_match_jax(tiny_dataset):
    jm, tm = jbuild(str(tiny_dataset)), build_manifest(str(tiny_dataset))
    np.testing.assert_array_equal(
        tsampler.imbalanced_sample_order(tm, seed=7),
        jsampler.imbalanced_sample_order(jm, seed=7))
    order = jsampler.imbalanced_sample_order(jm, seed=8)
    for shuffle in (False, True):
        want = jpipeline.batch_indices(len(jm), 5, shuffle=shuffle, seed=3,
                                       order=order)
        got = tpipeline.batch_indices(len(tm), 5, shuffle=shuffle, seed=3,
                                      order=order)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    class Fake:
        """Batches of 5 with a valid column, as a batcher yields them."""

        def iter_batches(self, batch_size, *, shuffle, seed, order):
            for plan in tpipeline.batch_indices(12, batch_size,
                                                shuffle=shuffle, seed=seed,
                                                order=order):
                n = len(plan)
                yield {"label": np.resize(plan, batch_size).astype(np.int32),
                       "valid": (np.arange(batch_size) < n).astype(np.int32),
                       "extra": np.zeros(batch_size)}

    got = list(tengine.stacked_batches(Fake(), 5, 2, seed=1,
                                       keys=("label", "valid")))
    want = list(jengine.stacked_batches(Fake(), 5, 2, seed=1,
                                        keys=("label", "valid")))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"label", "valid"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert got[-1]["valid"][-1].sum() == 0          # padded microbatch


def test_classification_report_matches_sklearn():
    """The port's numpy report (the train CLI logs it where sklearn is
    absent) equals sklearn's, value for value."""
    from sklearn.metrics import classification_report

    from garbage_classification_rca_tpu_torch import CLASS_DISPLAY_NAMES
    from garbage_classification_rca_tpu_torch.eval.report import (
        classification_report_dict)

    rng = np.random.default_rng(9)
    for n in (1, 7, 50):
        for collapse in (False, True):
            y = rng.integers(0, 4, n)
            p = np.zeros(n, np.int64) if collapse else rng.integers(0, 4, n)
            want = classification_report(
                y, p, labels=list(range(4)),
                target_names=list(CLASS_DISPLAY_NAMES), output_dict=True,
                zero_division=0)
            assert classification_report_dict(y, p) == want
