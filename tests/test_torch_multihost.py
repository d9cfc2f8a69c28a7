"""PyTorch port, multi-process runs (``parallel/multihost.py``, the eval
CLIs, the engine's RESUME agreement, the VLM step) over two gloo ranks on
the CPU, each launched by ``parallel.multihost.launch`` (a ``file://``
rendezvous in a temporary directory) with its own timeout. One launch
serves every two-rank case of this file.

  * the train stream: each rank's ``stacked_batches(rows=)`` share of
    every window makes the one-process window and the JAX package's
    ``stacked_train_stream`` window (shuffled and on the balanced
    sampler's order, tail padding and the trailing repeat included);
  * ``cli.test_image`` (ViT-B/16 cut to 2 layers) and ``cli.test_both``
    (MM-RCA, the EfficientNetV2 tower cut to one block a stage, 2-layer
    DistilBERT, 64 x 64 images) over two ranks: the predictions,
    labels, accuracy and report CSV equal the one-process port run's, and
    the report CSV (and, for test_both, the predictions) the JAX CLI's
    one-device run's;
  * a RESUME file seen by one rank and not the other, or written at
    another world size, stops both ranks (no hang);
  * a ``qformer_train`` step (tiny BLIP-2, the Q-Former's internal
    dropout on) over two ranks equals the one-process step.
"""

import copy
import dataclasses
import glob
import os
import textwrap

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu_torch.data.manifest import build_manifest
from garbage_classification_rca_tpu_torch.data.pipeline import ImageTextBatcher
from garbage_classification_rca_tpu_torch.parallel import multihost
from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
from garbage_classification_rca_tpu_torch.train.engine import (
    CHECKPOINT_FORMAT, stacked_batches)
from tests.test_torch_train_step import setup  # noqa: F401 — fixture

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "tests", "fixtures", "vocab")
TIMEOUT = 120


def launch_script(tmp_path, code, args=(), nproc=2, name="worker"):
    """Run `code` as `nproc` gloo ranks (``GC_RCA_PLATFORM=cpu``, one
    thread each) in `tmp_path`; asserts every rank exited 0."""
    script = tmp_path / f"{name}.py"
    script.write_text(textwrap.dedent(code))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["GC_RCA_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    res = multihost.launch([str(script), *map(str, args)], nproc,
                           timeout=TIMEOUT, env=env, cwd=str(tmp_path))
    for r, (code_, log) in enumerate(res):
        assert code_ == 0, f"rank {r}:\n{log[-4000:]}"
    return [log for _, log in res]


# ---------------------------------------------------------------------------
# the input stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("balanced", [False, True])
def test_stacked_train_stream_rows_make_the_global_stream(tiny_dataset,
                                                          balanced):
    import jax

    from garbage_classification_rca_tpu.data.manifest import (
        build_manifest as jbuild)
    from garbage_classification_rca_tpu.data.pipeline import (
        ImageTextBatcher as JBatcher)
    from garbage_classification_rca_tpu.data.sampler import (
        imbalanced_sample_order)
    from garbage_classification_rca_tpu.parallel import multihost as jmh
    from garbage_classification_rca_tpu.parallel.mesh import make_mesh

    m = build_manifest(str(tiny_dataset))
    order = imbalanced_sample_order(jbuild(str(tiny_dataset)), seed=3) \
        if balanced else None
    keys = ("image", "label", "valid")
    b = ImageTextBatcher(m, (24, 24), workers=2)
    jb = JBatcher(jbuild(str(tiny_dataset)), (24, 24), workers=2)
    try:
        # 12 samples, batch 8, acc 3: a padded tail batch and a trailing
        # window repeated with valid = 0
        ranks = [list(stacked_batches(b, 8, 3, seed=5, order=order, keys=keys,
                                      rows=DataMesh(r, 2).local_rows(8)))
                 for r in range(2)]
        one = list(stacked_batches(b, 8, 3, seed=5, order=order, keys=keys))
        mesh = make_mesh("data:2", jax.devices()[:2])
        want = [{k: np.asarray(v) for k, v in w.items()}
                for w in jmh.stacked_train_stream(jb, 8, 3, mesh, seed=5,
                                                  order=order, keys=keys)]
    finally:
        b.close()
        jb.close()
    assert len(ranks[0]) == len(ranks[1]) == len(one) == len(want) == 1
    for w0, w1, o, j in zip(*ranks, one, want):
        for k in keys:
            glob_ = np.concatenate([w0[k], w1[k]], axis=1)
            np.testing.assert_array_equal(glob_, o[k], err_msg=k)
            np.testing.assert_array_equal(glob_, j[k], err_msg=k)
    assert one[0]["valid"][1].sum() == 4 and one[0]["valid"][2].sum() == 0


# ---------------------------------------------------------------------------
# the one two-rank launch, and the eval CLIs over two ranks
# ---------------------------------------------------------------------------

WORKER = """
    import dataclasses, importlib, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from garbage_classification_rca_tpu_torch.cli import qformer_train
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        build_blip2)
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.image import (
        efficientnet_v2, vit)
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        initialize_from_env)
    from garbage_classification_rca_tpu_torch.train.engine import ResumePlan

    spec = torch.load(sys.argv[1], weights_only=False)
    rank = os.environ["RANK"]


    def qformer_step(mesh):
        # a Q-Former trainer step, tiny BLIP-2, internal dropout on, acc 2
        os.environ["GC_RCA_TINY_BLIP2"] = "1"
        args = args_parser(["--seed=3", f"--vocab_dir={spec['bpe']}"])
        _, model, _ = build_blip2(args, mesh.device, torch.float32,
                                  with_lora=False, classifier=True)
        opt, step, _ = qformer_train.make_steps(
            model, acc_steps=2, compute_dtype=torch.float32,
            hf_internal_dropout=True, mesh=mesh)
        rows = mesh.local_rows(spec["qf_window"]["label"].shape[1])
        local = {k: torch.from_numpy(v[:, rows])
                 for k, v in spec["qf_window"].items()}
        loss = step(local, Key(7))
        return {"loss": float(loss), "state": model.classifier.state_dict()}


    # rank 0: the one-process step first (rank 1 waits in the rendezvous)
    if rank == "0":
        torch.save(qformer_step(DataMesh(0, 1, torch.device("cpu"))),
                   "qf_one.pt")
    mesh = initialize_from_env("cpu")

    for case, path in spec["resume"].items():
        try:
            ResumePlan(path.replace("RANK", rank), mesh)
        except SystemExit as e:
            print(case, "EXIT", e, flush=True)
            continue
        sys.exit(4)

    out = qformer_step(mesh)
    if mesh.rank == 0:
        torch.save(out, "qf_two.pt")

    vit.CONFIGS["transformer_B16"] = dataclasses.replace(
        vit.CONFIGS["transformer_B16"], layers=2)
    efficientnet_v2.CONFIGS["eff_v2_medium"] = spec["image_cfg"]
    for cli, argv in spec["evals"].items():
        mod = importlib.import_module(
            "garbage_classification_rca_tpu_torch.cli." + cli)
        if cli == "test_both":
            mod.MULTIMODAL_IMAGE_SIZE = spec["mm_size"]
        evaluate = mod.evaluate

        def keep(args, evaluate=evaluate, cli=cli):
            out = evaluate(args)
            np.savez(f"../{cli}_rank{rank}.npz", acc=out[0], labels=out[1],
                     preds=out[2])
            return out

        mod.evaluate = keep
        os.makedirs(cli, exist_ok=True)
        os.chdir(cli)
        mod.main(argv + ["--mesh_shape=data:2"])
        os.chdir("..")
"""

MM_SIZE = (64, 64)


def _csv(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def _pil_route(monkeypatch):
    """The JAX batcher on its PIL + cv2 route, the one the port copies."""
    from garbage_classification_rca_tpu import native

    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)


def _like(template, flat, prefix=""):
    """`template`'s JAX tree filled with `flat`'s values (the names
    ``export_jax_tree`` gives)."""
    if isinstance(template, dict):
        return {k: _like(v, flat, f"{prefix}{k}.") for k, v in
                template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, flat, f"{prefix}{j}.")
                              for j, v in enumerate(template))
    return flat[prefix[:-1]]


@pytest.fixture(scope="module")
def mm_weights(setup):
    """MM-RCA's seeded init (the EfficientNetV2 tower cut, 2 text layers),
    whose predictions on the tiny dataset vary, and its JAX trees."""
    from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
        export_jax_tree)
    from garbage_classification_rca_tpu_torch.models.fusion import (
        multimodal as tmm)
    from tests.test_torch_train_step import SHORT_T

    cfg, params, state, _ = setup
    tcfg = tmm.FusionConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(tmm.FusionConfig)})
    model = tmm.FusionModel(tcfg, text_layers=2, image_cfg=SHORT_T,
                            generator=torch.Generator().manual_seed(1))
    flat = export_jax_tree(model)
    return model.state_dict(), _like(params, flat), _like(state, flat)


def _resume_file(d, world):
    from garbage_classification_rca_tpu_torch.nn.core import Key
    from garbage_classification_rca_tpu_torch.train import engine

    model = torch.nn.Linear(3, 2)
    model.layers = torch.nn.ModuleList()          # model_depth reads it
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    cwd = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        path = engine.save_train_state(
            model=model, optimizer=opt, model_name="m", key=Key(0), epoch=3,
            phase_name="train", scheduler=None,
            best=engine.PhaseResult(0.0, 0, None))
    finally:
        os.chdir(cwd)
    if world != 1:
        payload = torch.load(path, weights_only=True)
        payload["meta"]["world"] = world
        torch.save(payload, path)
    return path


RESUME_CASES = {"one_rank_sees_it": "resume point mismatch",
                "other_world_size": "written by a run of 1 ranks"}


@pytest.fixture(scope="module")
def two_ranks(mm_weights, tiny_dataset, tmp_path_factory):
    """The one two-rank launch (``WORKER``): the Q-Former step (and, on
    rank 0 before the group forms, the one-process step), the RESUME
    cases, then ``cli.test_image`` and ``cli.test_both``. Returns the
    directory, the eval argv, {cli: (rank 0's acc / labels / preds,
    report CSV)} and the ranks' logs."""
    from tests.test_torch_image_eval import _ref
    from tests.test_torch_train_step import SHORT_T

    d = tmp_path_factory.mktemp("two_ranks")
    vit_ckpt = d / "vit.pth"
    torch.save(_ref("transformer_B16", 224, seed=5).state_dict(), vit_ckpt)
    mm_ckpt = d / "mm_rca_best"
    torch.save({"format": CHECKPOINT_FORMAT, "meta": {"layers": 2},
                "state_dict": mm_weights[0]}, mm_ckpt)
    evals = {
        "test_image": ["--image_model=transformer_B16",
                       f"--model_path={vit_ckpt}"],
        "test_both": ["--late_fusion=MM_RCA", "--reverse",
                      "--text_model=distilbert", f"--model_path={mm_ckpt}",
                      f"--vocab_dir={VOCAB}/wordpiece", "--seq_len=16"]}
    for a in evals.values():
        a += [f"--dataset_folder_name={tiny_dataset}",
              "--compute_dtype=float32", "--eval_batch_size=8",
              "--data_workers=2"]
    # rank 0 finds a RESUME at epoch 3, rank 1 none (no shared
    # filesystem); then a file of a one-rank run seen by both
    _resume_file(str(d / "p0"), 1)
    resume = {"one_rank_sees_it": str(d / "pRANK" / "model_weights" / "m"
                                      / "RESUME"),
              "other_world_size": _resume_file(str(d / "shared"), 1)}
    rng = np.random.default_rng(0)
    window = {"image": rng.integers(0, 256, (2, 4, 224, 224, 3),
                                    dtype=np.uint8),
              "label": rng.integers(0, 4, (2, 4)).astype(np.int32),
              "valid": np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.int32)}
    spec = d / "spec.pt"
    torch.save({"image_cfg": SHORT_T, "mm_size": MM_SIZE, "evals": evals,
                "resume": resume, "qf_window": window,
                "bpe": os.path.join(VOCAB, "bpe")}, spec)
    logs = launch_script(d, WORKER, [spec])
    runs = {}
    for cli in evals:
        got = [np.load(d / f"{cli}_rank{r}.npz") for r in range(2)]
        for k in ("acc", "labels", "preds"):
            np.testing.assert_array_equal(got[0][k], got[1][k])
        runs[cli] = (got[0], _csv(str(d / cli / "test_set_reports")))
    return d, evals, runs, logs


def _one_process(tmp_path, monkeypatch, mod, argv, sub="one"):
    """`mod.main(argv)` in this process: (evaluate's output, report CSV)."""
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.chdir(d)
    kept = []
    evaluate = mod.evaluate
    monkeypatch.setattr(mod, "evaluate",
                        lambda args: kept.append(evaluate(args)) or kept[-1])
    mod.main(argv)
    monkeypatch.chdir(tmp_path)
    return kept[0], _csv(str(d / "test_set_reports"))


def _assert_same_eval(got, one):
    assert float(got["acc"]) == one[0]
    np.testing.assert_array_equal(got["labels"], one[1])
    np.testing.assert_array_equal(got["preds"], one[2])


def test_two_rank_test_image_matches_one_process_and_jax(
        two_ranks, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu.cli import test_image as jax_cli
    from garbage_classification_rca_tpu_torch.cli import test_image
    from tests.test_torch_image_eval import _small

    _, argv, runs, _ = two_ranks
    argv = argv["test_image"]
    got, csv2 = runs["test_image"]
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    _small(monkeypatch, "transformer_B16", 224)
    one, csv1 = _one_process(tmp_path, monkeypatch, test_image, argv)
    _assert_same_eval(got, one)
    assert csv2 == csv1
    _pil_route(monkeypatch)
    d = tmp_path / "jax"
    d.mkdir()
    monkeypatch.chdir(d)
    jax_cli.main(argv)
    assert csv2 == _csv(str(d / "test_set_reports"))


def test_two_rank_test_both_matches_one_process(
        two_ranks, mm_weights, tmp_path, monkeypatch):
    """The predictions vary (a seeded init, not a one-class model), so
    rows gathered out of order would show; the JAX CLI's run on the same
    weights gives the same predictions and CSV."""
    from garbage_classification_rca_tpu.cli import test_both as jax_cli
    from garbage_classification_rca_tpu.models.image import (
        efficientnet_v2 as jeffv2)
    from garbage_classification_rca_tpu_torch.cli import test_both
    from garbage_classification_rca_tpu_torch.models.image import (
        efficientnet_v2 as teffv2)
    from tests.test_torch_train_step import SHORT, SHORT_T

    _, argv, runs, _ = two_ranks
    argv = argv["test_both"]
    got, csv2 = runs["test_both"]
    assert len(np.unique(got["preds"])) > 1
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.setitem(teffv2.CONFIGS, "eff_v2_medium", SHORT_T)
    monkeypatch.setattr(test_both, "MULTIMODAL_IMAGE_SIZE", MM_SIZE)
    one, csv1 = _one_process(tmp_path, monkeypatch, test_both, argv)
    _assert_same_eval(got, one)
    assert csv2 == csv1

    # the JAX CLI on the same weights (its converter hands back the port
    # model's trees) and the same cut tower
    _, params, state = mm_weights
    _pil_route(monkeypatch)
    monkeypatch.setitem(jeffv2.CONFIGS, "eff_v2_medium", SHORT)
    monkeypatch.setattr(jax_cli, "MULTIMODAL_IMAGE_SIZE", MM_SIZE)
    monkeypatch.setattr(jax_cli, "load_torch_state_dict", lambda path: None)
    build = jax_cli.build_fusion

    def build_fusion(cfg):
        init_fn, apply_fn, _ = build(cfg)
        return init_fn, apply_fn, lambda sd: (copy.deepcopy(params),
                                              copy.deepcopy(state))

    monkeypatch.setattr(jax_cli, "build_fusion", build_fusion)
    kept = []
    run = jax_cli.run_multimodal_eval
    monkeypatch.setattr(jax_cli, "run_multimodal_eval",
                        lambda *a, **k: kept.append(run(*a, **k)) or kept[-1])
    d = tmp_path / "jax"
    d.mkdir()
    monkeypatch.chdir(d)
    jax_cli.main(argv)
    np.testing.assert_array_equal(got["labels"], kept[0][1])
    np.testing.assert_array_equal(got["preds"], kept[0][2])
    assert csv2 == _csv(str(d / "test_set_reports"))


# ---------------------------------------------------------------------------
# RESUME agreement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_mismatch_fails_fast_on_every_rank(two_ranks, case):
    """A RESUME seen by one rank only, or of another world size: every
    rank stops with the mismatch (and the launch goes on: no hang)."""
    for log in two_ranks[3]:
        line = next(ln for ln in log.splitlines() if ln.startswith(case))
        assert f"{case} EXIT" in line and RESUME_CASES[case] in line, line


# ---------------------------------------------------------------------------
# the Q-Former trainer's step over two ranks
# ---------------------------------------------------------------------------


def test_two_rank_qformer_train_step_matches_one_process(two_ranks):
    d = two_ranks[0]
    two = torch.load(d / "qf_two.pt", weights_only=True)
    one = torch.load(d / "qf_one.pt", weights_only=True)
    assert two["loss"] == pytest.approx(one["loss"], rel=1e-5, abs=1e-6)
    for k, v in one["state"].items():
        torch.testing.assert_close(two["state"][k], v, rtol=1e-4, atol=1e-6)
