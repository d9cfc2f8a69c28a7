"""PyTorch port, ``cli.test_text`` on GPT-2 and MobileBERT against the JAX
CLI on the ``tiny_dataset`` fixture (``GC_RCA_PLATFORM=cpu`` for the port).

Each side reads one synthesized reference-layout ``.pth`` (2 layers, full
width): GPT-2 with its whole 50,257-token vocabulary and the hash
tokenizer, whose rows are eos, words, eos, pad (50256, GPT-2's pad: the
pooled token counted from the ids); MobileBERT (and its reference
spelling ``mobile_bert``) with a pooler, a 1000-token vocabulary and the
WordPiece fixture vocabulary. The report CSV must be byte-identical to
the JAX CLI's, its name and its bytes, with fp32 weights computing in fp32
(the default ``--param_dtype`` under ``--compute_dtype=float32``, and
``--param_dtype=float32 --compute_dtype=bfloat16``: both CLIs compute in
the dtype of the weights). With ``--param_dtype=bfloat16
--compute_dtype=float32`` both CLIs run on bf16 weights; their models'
logits on the CLI's batch agree within 3e-2 of max |logit|.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import gpt2 as jgpt2
from garbage_classification_rca_tpu.models.text import mobilebert as jmb
from garbage_classification_rca_tpu_torch.cli import test_text as port_cli
from garbage_classification_rca_tpu_torch.models.text import mobilebert as tmb
from tests.test_torch_gpt2 import gpt2_state_dict
from tests.test_torch_mobilebert_port import mobilebert_state_dict

torch.set_num_threads(2)

LAYERS = 2
WORDPIECE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab",
                         "wordpiece")
NAMES = ("gpt2", "mobilebert", "mobile_bert")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("text_family")
    out = {}
    for name, sd in (
            ("gpt2", gpt2_state_dict(11, vocab=jgpt2.VOCAB)),
            ("mobilebert", mobilebert_state_dict(12, pooler=True))):
        path = d / f"{name}.pth"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        out[name] = str(path)
    out["mobile_bert"] = out["mobilebert"]
    return out


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setattr(jgpt2, "LAYERS", LAYERS)
    monkeypatch.setattr(jmb, "LAYERS", LAYERS)
    monkeypatch.setattr(tmb, "VOCAB", 1000)


def _argv(name, ckpt, dataset, flags):
    vocab = [] if name == "gpt2" else [f"--vocab_dir={WORDPIECE}"]
    return [f"--text_model={name}", f"--model_path={ckpt}",
            f"--dataset_folder_name={dataset}", "--eval_batch_size=8"] \
        + vocab + flags


def _csv(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def _run(main, argv, d, monkeypatch):
    d.mkdir()
    monkeypatch.chdir(d)
    main(argv)
    return _csv(str(d / "test_set_reports"))


@pytest.mark.parametrize("flags", [
    ["--compute_dtype=float32"],
    ["--param_dtype=float32", "--compute_dtype=bfloat16"]],
    ids=["fp32", "fp32_weights_bf16_compute"])
@pytest.mark.parametrize("name", NAMES)
def test_port_cli_report_matches_jax_cli(name, flags, checkpoints,
                                         tiny_dataset, tmp_path, monkeypatch):
    from garbage_classification_rca_tpu.cli import test_text as jax_cli

    argv = _argv(name, checkpoints[name], tiny_dataset, flags)
    want = _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    got = _run(port_cli.main, argv, tmp_path / "port", monkeypatch)
    assert got == want
    assert got[0].startswith(f"text_model_{name}_report_test_set_acc_")


@pytest.mark.parametrize("name", ["gpt2", "mobilebert"])
def test_bf16_weights_fp32_compute_match_jax_cli(name, checkpoints,
                                                 tiny_dataset, tmp_path,
                                                 monkeypatch):
    """Both CLIs with ``--param_dtype=bfloat16 --compute_dtype=float32``:
    the weights each evaluates with are bf16, and the logits of those
    weights on one batch agree within the bf16 bar."""
    from garbage_classification_rca_tpu.cli import test_text as jax_cli

    seen = {}
    jax_step = jax_cli.make_text_eval_step

    def jax_wrap(apply_fn, mesh, **kw):
        step = jax_step(apply_fn, mesh, **kw)

        def record(params, state, batch):
            seen.setdefault("jax", (apply_fn, params))
            seen.setdefault("batch", batch)
            return step(params, state, batch)

        return record

    port_step = port_cli.make_text_eval_step

    def port_wrap(model):
        seen["port"] = model
        return port_step(model)

    monkeypatch.setattr(jax_cli, "make_text_eval_step", jax_wrap)
    monkeypatch.setattr(port_cli, "make_text_eval_step", port_wrap)
    argv = _argv(name, checkpoints[name], tiny_dataset,
                 ["--param_dtype=bfloat16", "--compute_dtype=float32"])
    _run(jax_cli.main, argv, tmp_path / "jax", monkeypatch)
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    _run(port_cli.main, argv, tmp_path / "port", monkeypatch)

    apply_fn, params = seen["jax"]
    model, batch = seen["port"], seen["batch"]
    assert {a.dtype for a in jax.tree_util.tree_leaves(params)} == {
        jnp.dtype(jnp.bfloat16)}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    ids = np.array(batch["input_ids"])
    mask = np.array(batch["attention_mask"])
    want = np.asarray(apply_fn(params, {}, (jnp.asarray(ids),
                                            jnp.asarray(mask)))[0],
                      np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).float()
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 3e-2 * np.abs(want).max()
