"""PyTorch port, the data axis (``parallel/mesh.py``, ``nn/core.py``'s
``batch_shard``, ``train/loop.py`` over ranks).

The mesh arithmetic against the JAX package's functions on the same
inputs (``parse_mesh_shape``, ``mesh_for_batch``, ``round_up_batch``,
``clamp_eval_batch``, ``train_mesh``, ``pad_batch_to_multiple``), the
global random draws of ``rand_rows``, and the two-rank MM-RCA train step
on gloo (one ``parallel.multihost.launch`` of ``chip_smoke.dp_step_worker``
runs both cases): with train-mode
BatchNorm, class weights, a padded row in rank 1's share, augmentation,
head dropout, stochastic depth and the text tower's internal dropout at
acc 2, it equals the one-process step of the same global batch (fp32:
loss 1e-5, gradients and updated weights 1e-4 of each tensor's largest
|value|, BN running statistics 1e-5); without the random sites it equals
the JAX package's one-device step (its ``tests/test_multihost.py`` bars:
loss rtol 1e-5 / atol 1e-6, weights rtol 1e-4 / atol 2e-5).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from garbage_classification_rca_tpu import cli as jcli
from garbage_classification_rca_tpu.models.image import (
    efficientnet_v2 as jeffv2)
from garbage_classification_rca_tpu.parallel import mesh as jmesh
from garbage_classification_rca_tpu_torch import cli as tcli
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    export_jax_tree)
from garbage_classification_rca_tpu_torch.models.fusion import multimodal as tmm
from garbage_classification_rca_tpu_torch.nn import core
from garbage_classification_rca_tpu_torch.parallel import mesh as tmesh
from garbage_classification_rca_tpu_torch.parallel import multihost
from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
from tests.test_torch_train_step import (  # noqa: F401 — fixture
    CLASS_WEIGHTS, LR, REG, SHORT, SHORT_T, SMOOTH, _jax_step, setup)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120


def _jax_mesh_axes(m):
    return dict(zip(m.axis_names, m.devices.shape))


@pytest.mark.parametrize("spec,n", [
    ("data:-1", 1), ("data:-1", 2), ("data:-1", 8), ("data:4", 8),
    ("data:2,model:2", 8), ("data:-1,model:2", 8), ("data", 4),
    ("data:1,pipe:2", 4)])
def test_parse_mesh_shape_matches_jax(spec, n):
    assert tmesh.parse_mesh_shape(spec, n) == jmesh.parse_mesh_shape(spec, n)


@pytest.mark.parametrize("spec,batch,n", [
    ("data:-1", 16, 8), ("data:-1", 4, 8), ("data:-1", 6, 8),
    ("data:-1", 3, 8), ("data:4", 10, 8), ("data:-1", 0, 8),
    ("data:2,model:2", 3, 8)])
def test_mesh_for_batch_matches_jax(spec, batch, n, capsys):
    want = _jax_mesh_axes(jmesh.mesh_for_batch(spec, batch,
                                               jax.devices()[:n]))
    jnote = capsys.readouterr().out
    assert tmesh.mesh_for_batch(spec, batch, n) == want
    assert capsys.readouterr().out == jnote      # the same note, or none


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("batch,n_samples", [
    (256, 16), (256, 17), (256, 5000), (256, 3), (7, 100), (1, 0)])
def test_round_up_and_clamp_eval_batch_match_jax(n, batch, n_samples):
    jm = jmesh.make_mesh(f"data:{n}", jax.devices()[:n])
    tm = DataMesh(0, n)
    assert tmesh.round_up_batch(batch, tm) == jmesh.round_up_batch(batch, jm)
    assert tmesh.clamp_eval_batch(batch, n_samples, tm) == \
        jmesh.clamp_eval_batch(batch, n_samples, jm)
    assert tmesh.clamp_eval_batch(batch, n_samples, None) == \
        jmesh.clamp_eval_batch(batch, n_samples, None)


@pytest.mark.parametrize("spec,b,ft,ft_epochs,n", [
    ("data:-1", 16, 8, 1, 8), ("data:-1", 12, 8, 1, 8),
    ("data:-1", 12, 8, 0, 8), ("data:-1", 4, 4, 1, 2),
    ("data:2", 6, 9, 1, 2), ("data:-1,model:2", 8, 4, 1, 8)])
def test_train_mesh_matches_jax(spec, b, ft, ft_epochs, n, monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:n])
    want = _jax_mesh_axes(jcli.train_mesh(spec, b, ft, ft_epochs))
    assert tcli.train_mesh(spec, b, ft, ft_epochs, n) == want


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (1, 8), (3, 1)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    arrays = {"image": rng.integers(0, 255, (n, 4, 4, 3)).astype(np.uint8),
              "label": rng.integers(0, 4, (n,)).astype(np.int32)}
    got, gn = tmesh.pad_batch_to_multiple(arrays, multiple)
    want, wn = jmesh.pad_batch_to_multiple(arrays, multiple)
    assert gn == wn
    for k in arrays:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_local_rows_are_contiguous_blocks():
    rows = [DataMesh(r, 4).local_rows(16) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(16))
    with pytest.raises(ValueError, match="does not split"):
        DataMesh(0, 4).local_rows(6)


@pytest.mark.parametrize("normal", [False, True])
def test_rand_rows_draws_the_global_batch(normal):
    """Under ``batch_shard`` each rank draws the global batch's values and
    keeps its block: the ranks' draws concatenate to the one-device draw;
    a keep mask and augmentation's draws follow."""
    g = lambda: torch.Generator().manual_seed(3)          # noqa: E731
    draw = torch.randn if normal else torch.rand
    want = draw((6, 5, 2), generator=g())
    got = []
    for r in range(3):
        with core.batch_shard(DataMesh(r, 3)):
            got.append(core.rand_rows((2, 5, 2), g(), "cpu", normal=normal))
    torch.testing.assert_close(torch.cat(got), want, rtol=0, atol=0)
    key = core.Key(9)
    with core.batch_shard(DataMesh(1, 2)):
        half = key.keep_mask((2, 3, 4, 4), 0.1, "cpu")
    assert torch.equal(half, key.keep_mask((4, 3, 4, 4), 0.1, "cpu")[2:])
    with core.batch_shard(DataMesh(0, 1)):          # one rank: unchanged
        assert torch.equal(core.rand_rows((2, 3), g(), "cpu"),
                           torch.rand((2, 3), generator=g()))


# ---------------------------------------------------------------------------
# the two-rank MM-RCA train step
# ---------------------------------------------------------------------------


def _stack(seed, acc=2, b=4, n=16, size=64):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, n + 1, (acc, b))
    mask = (np.arange(n)[None, None, :] < lens[..., None]).astype(np.int32)
    valid = np.ones((acc, b), np.int32)
    valid[1, -1] = 0                     # a padded row in rank 1's share
    return {"image": rng.integers(0, 256, (acc, b, size, size, 3),
                                  dtype=np.uint8),
            "input_ids": (rng.integers(1000, 30000, (acc, b, n)) * mask
                          ).astype(np.int32),
            "attention_mask": mask,
            "label": rng.integers(0, 4, (acc, b)).astype(np.int32),
            "valid": valid}


def _port_model(params, state, cfg, image_cfg):
    tcfg = tmm.FusionConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tmm.FusionConfig)})
    return tmm.load_fusion_model(params, state, tcfg, device="cpu",
                                 image_cfg=image_cfg)


def _random_case(setup):
    """BN in train mode, class weights, a padded row, augmentation p=1,
    head dropout, stochastic depth and DistilBERT's internal dropout (the
    flash attention's keep masks), acc 2: (model factory, spec)."""
    cfg, params, state, _ = setup
    cfg = dataclasses.replace(cfg, drop_ratio=0.5, hf_internal_dropout=True)
    image_cfg = dataclasses.replace(SHORT_T, sd_prob=0.3)
    spec = {"stack": _stack(11), "image_dtype": "float32",
            "class_weights": CLASS_WEIGHTS, "prob_aug": 1.0, "lr": LR,
            "reg": REG, "label_smoothing": SMOOTH, "key": 5}
    return lambda: _port_model(params, state, cfg, image_cfg), spec


def _jax_case(setup):
    """Without the random sites, for the JAX one-device step."""
    cfg, params, state, _ = setup
    spec = {"stack": _stack(12), "image_dtype": "float32",
            "class_weights": CLASS_WEIGHTS, "prob_aug": 0.0, "lr": LR,
            "reg": REG, "label_smoothing": SMOOTH, "key": 6}
    return lambda: _port_model(params, state, cfg, SHORT_T), spec


@pytest.fixture(scope="module")
def two_rank_steps(setup, tmp_path_factory):
    """Both cases' steps in one launch of ``chip_smoke.dp_step_worker`` as
    two gloo ranks on the CPU: {case: [rank 0's result, rank 1's]}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GC_RCA_PLATFORM", None)
    paths = {}
    for name, case in (("random", _random_case), ("jax", _jax_case)):
        make, spec = case(setup)
        d = tmp_path_factory.mktemp(name)
        paths[name] = d
        torch.save(dict(spec, model=make(), device="cpu", out=str(d),
                        threads=1), d / "spec.pt")
    res = multihost.launch(
        ["chip_smoke.py",
         "--dp_step=" + ",".join(str(d / "spec.pt") for d in paths.values())],
        2, timeout=WORKER_TIMEOUT, env=env, cwd=ROOT)
    for code, log in res:
        assert code == 0, log[-3000:]
    return {name: [torch.load(d / f"rank{r}.pt", weights_only=False)
                   for r in range(2)] for name, d in paths.items()}


def _assert_step_equal(got, want, zero, g_bar=1e-4, s_bar=1e-5):
    """fp32 bars; `zero`: the gradients that are zero in exact arithmetic
    (rounding noise on both sides), sized against their siblings."""
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1, abs(want["loss"]))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    for k in ("grad_norm", "param_norm"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for n, e in chip_smoke.dp_grad_errors(got["grads"], want["grads"],
                                          zero).items():
        assert e <= g_bar, (n, e)
    for n, e in chip_smoke.dp_grad_errors(got["state"],
                                          want["state"]).items():
        assert e <= (s_bar if n.endswith((".mean", ".var")) else g_bar), n


def test_two_rank_step_with_the_recipes_randomness_equals_one_process(
        setup, two_rank_steps):
    """Each rank draws the global microbatch's values and keeps its rows,
    BN's statistics are the global batch's, and the division is by the
    global weight sum (``_random_case``)."""
    ranks = two_rank_steps["random"]
    make, spec = _random_case(setup)
    one = make()
    want = chip_smoke.run_dp_step(one, spec,
                                  DataMesh(0, 1, torch.device("cpu")))
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[0]["backend"] == "gloo"
    _assert_step_equal(ranks[0], want, chip_smoke.exact_zero_grads(one))


def test_two_rank_step_equals_the_jax_one_device_step(setup, two_rank_steps,
                                                      monkeypatch):
    """Without the random sites: the two-rank step against the JAX
    package's one-device ``make_train_step`` on the same weights and global
    stack (BN in train mode, class weights, label smoothing, a padded
    row)."""
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
    cfg, params, state, _ = setup
    make, spec = _jax_case(setup)
    want = _jax_step(cfg, params, state, spec["stack"], True,
                     jax.numpy.float32)
    got = two_rank_steps["jax"][0]
    np.testing.assert_allclose(got["loss"], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want[2], rtol=1e-4)
    model = make()
    model.load_state_dict(got["state"])
    tree = export_jax_tree(model)
    new_p, new_s = want[4], want[5]
    for k, v in tree.items():
        w = new_s[k] if k in new_s else new_p[k]
        np.testing.assert_allclose(v, w, rtol=1e-4, atol=2e-5, err_msg=k)


def test_data_mesh_refuses_what_the_port_does_not_run(monkeypatch):
    """data:N outside an N-rank world names the launcher; the JAX divisor
    shrink exits with its numbers; the other axes raise as item 7."""
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    for k in ("RANK", "WORLD_SIZE", "GC_RCA_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    args = lambda spec: type("A", (), {"mesh_shape": spec})()  # noqa: E731
    assert tcli.data_mesh(args("data:-1")).world == 1
    assert tcli.data_mesh(args("data:1")).backend is None
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node=4"):
        tcli.data_mesh(args("data:4"))
    monkeypatch.setattr(multihost, "env_world_size", lambda: 4)
    with pytest.raises(SystemExit, match="would use data:2"):
        tcli.data_mesh(args("data:-1"), train_batches=(6, 6, 1))
    for spec in ("data:2,model:2", "pipe:2", "data:1,seq:2", "expert:2"):
        with pytest.raises(NotImplementedError, match="item 7"):
            tcli.data_mesh(args(spec))
